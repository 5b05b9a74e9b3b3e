"""The egress render, byte for byte on both outputs and on every row.

- `egress.render_plain` (the plain PyTorch version) against the
  reference's device egress program (`etl_tpu/ops/egress.py::
  build_egress_program`, jitted on the CPU), for every renderable kind
  under each encoder that renders it, on seeded adversarial words: the
  decode of junk, out-of-range and edge texts (integer extremes, dates at
  year ends, TIMESTAMPTZ shifted across midnight and year ends) and rows
  of random bits, in layouts where fields straddle two words.
- The render kernel's own code (`csrc/egress_render.cu` compiled as host
  C++: `etl_egress_render_host` runs the kernel's row body for every row)
  against the plain version, on the same words and on the main path's
  layout.
- The wrapper's checks. tests/test_torch_kernels_gpu.py holds the
  compiled kernel against the plain version on the card.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_egress_render.py -q
"""

import ctypes
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from etl_tpu.models.pgtypes import CellKind as RK
from etl_tpu.ops import egress as ref_egress
from etl_tpu_torch.models.pgtypes import CellKind as K
from etl_tpu_torch.ops import egress as eg
from etl_tpu_torch.ops import egress_kernel as ek
from etl_tpu_torch.ops.bitpack import layout_for_specs, saturation_width
from etl_tpu_torch.testing import egress_words

WIDTHS = {K.BOOL: 4, K.I16: 8, K.I32: 12, K.U32: 12, K.I64: 20,
          K.DATE: 16, K.TIMESTAMP: 32, K.TIMESTAMPTZ: 32}
CASES = [(enc, k) for enc in (eg.ENCODER_TSV, eg.ENCODER_JSON)
         for k in WIDTHS if k in eg.ENCODER_KINDS[enc]]


def _bw(kind, w):
    return (min(w, saturation_width(kind)) + 1) & ~1


def kind_specs(kind):
    """The kind at its full width and at a narrow one (integers: fewer
    bits), after a BOOL and between I64s, so its fields sit at odd bit
    offsets and straddle words; a float column the render skips."""
    w = WIDTHS[kind]
    narrow = max(w // 2, 10 if kind is K.DATE else 19 if kind in (
        K.TIMESTAMP, K.TIMESTAMPTZ) else 2)
    narrow += narrow % 2
    cols = [(K.BOOL, 4), (kind, w), (K.I64, 20), (kind, narrow),
            (K.F64, 24), (K.I64, 8), (kind, w)]
    return tuple((i, k, cw, _bw(k, cw)) for i, (k, cw) in enumerate(cols))


def ref_render(words, specs, encoder):
    rspecs = tuple((i, RK[k.name], w, bw) for i, k, w, bw in specs)
    plan = ref_egress.plan_for_specs(rspecs, encoder)
    fn = jax.jit(ref_egress.build_egress_program(rspecs, plan))
    eb, el = fn(jnp.asarray(words.view(torch.int32).numpy().view(np.uint32)))
    return np.asarray(eb), np.asarray(el)


def _assert_same(got, want, what):
    for g, w, name in zip(got, want, ("ebytes", "elens")):
        g = np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name)
        bad = np.flatnonzero((g != w).reshape(len(g), -1).any(axis=1))
        assert bad.size == 0, (what, name, bad[:5], g[bad[:2]], w[bad[:2]])


@pytest.mark.parametrize("encoder,kind", CASES,
                         ids=[f"{e}-{k.name}" for e, k in CASES])
def test_plain_matches_reference_program(encoder, kind):
    specs = kind_specs(kind)
    words = egress_words(specs, 3000, np.random.default_rng(
        40 + 3 * kind.value + len(encoder)))
    plan = eg.plan_for_specs(specs, encoder)
    assert plan is not None and kind in plan.kinds
    got = eg.render_plain(words, specs, plan)
    _assert_same(got, ref_render(words, specs, encoder),
                 f"{encoder} {kind.name}")


@pytest.mark.parametrize("encoder", [eg.ENCODER_TSV, eg.ENCODER_JSON])
def test_plain_matches_reference_all_kinds_random_bits(encoder):
    """Every renderable kind in one layout, every word random: each field
    holds any bit pattern its width allows."""
    specs = tuple((i, k, w, _bw(k, w)) for i, (k, w) in
                  enumerate(list(WIDTHS.items()) * 2))
    rng = np.random.default_rng(7 + len(encoder))
    n_words = layout_for_specs(specs).n_words
    words = torch.from_numpy(rng.integers(
        -2**31, 2**31, size=(n_words, 2048), dtype=np.int64)
        .astype(np.int32)).view(torch.uint32)
    got = eg.render_plain(words, specs, eg.plan_for_specs(specs, encoder))
    _assert_same(got, ref_render(words, specs, encoder), encoder)


def test_render_plain_texts_are_the_values():
    """On rows that parsed, the rendered text is the value's own text."""
    specs = ((0, K.I32, 12, 12), (1, K.I64, 20, 20), (2, K.DATE, 16, 2),
             (3, K.TIMESTAMPTZ, 32, 2), (4, K.BOOL, 4, 2))
    from etl_tpu_torch.ops.bitpack import parse_and_pack_plain
    from etl_tpu_torch.testing import text_matrix

    cols = [["-2147483648", "0", "42"],
            ["-9223372036854775808", "1000000000", "7"],
            ["0001-01-01", "1999-12-31", "2000-02-29"],
            ["1999-12-31 23:30:00-05", "2000-01-01 00:30:00+09:30",
             "9999-12-31 23:59:59.999999+00"],
            ["t", "f", "t"]]
    bm, ln = text_matrix(specs, cols)
    words = parse_and_pack_plain(torch.from_numpy(bm), torch.from_numpy(ln),
                                 specs, False)
    plan = eg.plan_for_specs(specs, eg.ENCODER_TSV)
    eb, el = eg.render_plain(words, specs, plan)
    texts = [[bytes(eb[i, o:o + el[i, j]].numpy()).decode()
              for j, o in enumerate(plan.offsets)] for i in range(3)]
    assert texts == [
        ["-2147483648", "-9223372036854775808", "0001-01-01",
         "2000-01-01 04:30:00.000000", "true"],
        ["0", "1000000000", "1999-12-31", "1999-12-31 15:00:00.000000",
         "false"],
        ["42", "7", "2000-02-29", "9999-12-31 23:59:59.999999", "true"]]


# -- the kernel's code as host C++ --------------------------------------------


@pytest.fixture(scope="module")
def host_render(tmp_path_factory):
    so = tmp_path_factory.mktemp("egress_render") / "egress_render_host.so"
    subprocess.run([os.environ.get("CXX", "c++"), "-O2", "-std=c++17",
                    "-shared", "-fPIC", "-x", "c++", str(ek.SOURCE), "-o",
                    str(so)], check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    fn = lib.etl_egress_render_host
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    for name, want in (("etl_egress_max_cols", eg.EGRESS_MAX_COLS),
                       ("etl_egress_desc_stride", ek.DESC_STRIDE)):
        getattr(lib, name).restype = ctypes.c_int
        assert getattr(lib, name)() == want

    def run(words, specs, plan):
        w = np.ascontiguousarray(words.view(torch.int32).numpy())
        desc = np.asarray(ek.descriptor(specs, plan), dtype=np.int32)
        R = w.shape[1]
        # poisoned outputs: every byte and length must be written
        eb = np.full((R, plan.total_width), 0xA5, dtype=np.uint8)
        el = np.full((R, len(plan.slots)), -7, dtype=np.int32)
        fn(w.ctypes.data, R, desc.ctypes.data, len(plan.slots),
           plan.total_width, eb.ctypes.data, el.ctypes.data)
        return eb, el

    return run


@pytest.mark.parametrize("encoder,kind", CASES,
                         ids=[f"{e}-{k.name}" for e, k in CASES])
def test_host_kernel_matches_plain(host_render, encoder, kind):
    specs = kind_specs(kind)
    words = egress_words(specs, 3000, np.random.default_rng(
        90 + 3 * kind.value + len(encoder)))
    plan = eg.plan_for_specs(specs, encoder)
    want = [t.numpy() for t in eg.render_plain(words, specs, plan)]
    _assert_same(host_render(words, specs, plan), want,
                 f"{encoder} {kind.name}")


def test_host_kernel_main_path_layout(host_render):
    """pgbench_accounts' three INT4 columns, nibble-packed, as the main
    path's decoder packs them."""
    specs = ((0, K.I32, 12, 12), (1, K.I32, 12, 6), (2, K.I32, 12, 12))
    words = egress_words(specs, 4096, np.random.default_rng(5), nibble=True)
    plan = eg.plan_for_specs(specs, eg.ENCODER_TSV)
    assert plan.total_width == 33
    want = [t.numpy() for t in eg.render_plain(words, specs, plan)]
    _assert_same(host_render(words, specs, plan), want, "pgbench")


def test_host_kernel_widest_plan(host_render):
    """EGRESS_MAX_COLS columns of every kind, random bits."""
    kinds = list(WIDTHS.items()) * 4
    specs = tuple((i, k, w, _bw(k, w)) for i, (k, w) in enumerate(kinds))
    plan = eg.plan_for_specs(specs, eg.ENCODER_TSV)
    assert len(plan.slots) == eg.EGRESS_MAX_COLS
    rng = np.random.default_rng(11)
    words = torch.from_numpy(rng.integers(
        -2**31, 2**31, size=(layout_for_specs(specs).n_words, 777),
        dtype=np.int64).astype(np.int32))
    want = [t.numpy() for t in eg.render_plain(words, specs, plan)]
    _assert_same(host_render(words, specs, plan), want, "widest")


# -- the wrapper ----------------------------------------------------------------


def test_wrapper_on_cpu_is_the_plain_version():
    specs = kind_specs(K.TIMESTAMPTZ)
    words = egress_words(specs, 300, np.random.default_rng(3))
    plan = eg.plan_for_specs(specs, eg.ENCODER_TSV)
    for fn in (eg.render, ek.render):
        got = fn(words, specs, plan)
        want = eg.render_plain(words, specs, plan)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wrapper_checks_inputs_and_devices():
    specs = ((0, K.I32, 12, 12),)
    plan = eg.plan_for_specs(specs, eg.ENCODER_TSV)
    n_words = layout_for_specs(specs).n_words
    with pytest.raises(ValueError, match="unsupported device"):
        ek.render(torch.zeros((n_words, 8), dtype=torch.int32,
                              device="meta"), specs, plan)
    with pytest.raises(ValueError, match="do not fit"):
        ek.render(torch.zeros((n_words + 1, 8), dtype=torch.int32), specs,
                  plan)
    with pytest.raises(ValueError, match="do not fit"):
        ek.render(torch.zeros((n_words, 8), dtype=torch.int64), specs, plan)


def test_descriptor_layout():
    """Per rendered column: kind, width, offset, 0, then (present,
    bit_off, bits, zigzag) per component; absent components are zeros."""
    specs = ((0, K.F64, 24, 18), (1, K.I64, 8, 8), (2, K.BOOL, 4, 2))
    plan = eg.plan_for_specs(specs, eg.ENCODER_TSV)
    desc = ek.descriptor(specs, plan)
    assert len(desc) == 2 * ek.DESC_STRIDE
    layout = layout_for_specs(specs)
    i64 = {s.comp: s for s in layout.slots[1]}
    assert desc[:4] == [4, 20, 0, 0]
    assert desc[4:8] == [1, i64["neg"].bit_off, 1, 0]
    assert desc[8:12] == [1, i64["l0"].bit_off, i64["l0"].bits, 0]
    assert desc[12:20] == [0] * 8  # l1, l2: not packed for 8 digits
    b = desc[ek.DESC_STRIDE:]
    assert b[:4] == [0, 5, 20, 0]
    assert b[4:8] == [1, layout.slots[2][1].bit_off, 1, 0]
