"""The port's C framer (`etl_tpu_torch/native/framer.c`) under AddressSanitizer
and UBSan: `python -m etl_tpu_torch.testing.sanitize_framer` builds it
with `-fsanitize=address,undefined -fno-sanitize-recover` and runs the
fuzz target `framer`, the framer differentials and the pack/gather hammer
in child processes that load the instrumented library. Exit code 77 (no
sanitizers in this toolchain) skips; any finding fails. The
differentials and the hammer also run here in-process, on the store's
-O3 build."""

import os
import random
import subprocess
import sys

import pytest

from etl_tpu_torch.testing import sanitize_framer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_framer_under_asan_ubsan():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run(
        [sys.executable, "-m", "etl_tpu_torch.testing.sanitize_framer",
         "--seconds", "1.5", "--seed", "42"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    if proc.returncode == sanitize_framer.SKIP:
        pytest.skip(proc.stderr.strip()[-200:])
    assert proc.returncode == 0, \
        f"sanitizer findings:\n{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}"
    assert "sanitized framer loaded" in proc.stdout
    assert "no findings" in proc.stdout


def test_differentials_hold_on_the_store_build():
    assert sanitize_framer.differentials(0.0, 7) >= 50


def test_hammer_runs_on_the_store_build():
    assert sanitize_framer.hammer(0.0, 7) >= 20


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_truncation_stops_at_the_cut(seed):
    """One differential case: a valid stream, field by field against the
    codec, then cut short and read with one column too many."""
    sanitize_framer.framer_case(random.Random(seed))
