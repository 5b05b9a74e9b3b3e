"""The port's etl-lint IR tier (`etl_tpu_torch.analysis.ir`) on the CPU,
the reference's tests/test_ir_analysis.py restated for kernel launches.

Falsifiability: every contract FIRES on a deliberately violating program
— the checkers, pure functions of a run's record, get a bad record, and
the runner gets a launch wrapper that breaks the contract — and stays
quiet on the real programs. On the CPU the launches are the kernels'
plain versions (the host route's and the `--device cpu` run's), as the
reference's tests run its programs on the CPU backend; the card's half
(`ir-host-callback` under CUDA's sync debug mode, launches held against
their plain versions) is in tests/test_torch_kernels_gpu.py and
`chip_smoke.py` phase 21.

Determinism: two runs over the same layout set give byte-identical
findings JSON and path sets. Wiring: the CLI's `--programs`/`--ir`,
`--device`, `--mesh` and the cross-tier baseline staleness.
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from etl_tpu_torch.analysis.ir import (IR_CONTRACT_NAMES, IR_NAMESPACE,
                                       contracts)
from etl_tpu_torch.analysis.ir.catalog import (KERNEL_OF_VARIANT,
                                               ProgramDescriptor,
                                               build_catalog, layout_tag)
from etl_tpu_torch.analysis.ir.runner import (Record, analyze_descriptor,
                                              analyze_local,
                                              recording_collectives,
                                              run_program, sync_checked)

REPO = Path(__file__).resolve().parent.parent


def _program(variant: str, prefix: str = "i32x3", bucket: int = 256):
    return next(d for d in build_catalog(row_buckets=(bucket,),
                                         include_observed=False)
                if d.variant == variant and d.tag.startswith(prefix))


def _rules(found) -> list:
    return [f.rule for f in found]


# ---------------------------------------------------------------------------
# falsifiability — one deliberately-bad program per contract
# ---------------------------------------------------------------------------

class TestContractsFire:
    def test_host_callback_fires(self):
        """The checker over a record holding a raised sync: one finding
        per site; the window records a sync-debug raise as a site and
        aborts, and lets any other error through."""
        hits = contracts.check_host_callback(["ops/x.py:probe",
                                              "ops/x.py:probe"])
        assert [d for d, _ in hits] == ["sync@ops/x.py:probe"]

        def synchronising():
            raise RuntimeError("called a synchronizing CUDA operation")

        rec = Record()
        # `enabled` is the card's; the CPU never enters the mode, so the
        # window's bookkeeping is driven here without it
        rec.sync_events = []
        try:
            synchronising()
        except RuntimeError as e:
            from etl_tpu_torch.analysis.ir.runner import (_is_sync_raise,
                                                          _sync_site)

            assert _is_sync_raise(e)
            rec.sync_events.append(_sync_site(e))
        assert rec.sync_events == \
            ["test_torch_ir_analysis.py:synchronising"]
        with pytest.raises(ValueError):
            with sync_checked(Record(), enabled=False):
                raise ValueError("not a sync")

    def test_host_callback_not_checked_on_the_cpu(self):
        """A real program on the CPU: the contract is not checkable, the
        record says so (None, not an empty list), and the run's report
        lists it as `not_checked: cpu`."""
        rec = run_program(_program("device"), "cpu")
        assert rec.sync_events is None and not rec.aborted
        _, _, report = analyze_local(device="cpu", row_buckets=(64,),
                                     include_observed=False)
        assert report["not_checked"] == {"ir-host-callback": "cpu"}
        assert report["findings"]["ir-host-callback"] == 0

    def test_donation_fires(self):
        """The checker: an output that shares storage with an input (a
        view of it) fires; a real K1 program's record is clean."""
        rec = run_program(_program("device"), "cpu")
        bmat = dict(rec.inputs)["bmat"]
        hits = contracts.check_donation(
            rec.inputs, [("words", rec.outputs[0][1]),
                         ("alias", bmat[:4])])
        assert [d for d, _ in hits] == ["alias<-bmat"]
        assert contracts.check_donation(rec.inputs, rec.outputs) == []

    def test_donation_fires_through_the_runner(self, monkeypatch):
        """A K1 wrapper whose launch hands back its input matrix: the port
        declares no donation, so the output aliasing an input fires."""
        from etl_tpu_torch.ops import decode_kernel

        real = decode_kernel.prepare_decode_pack

        def aliasing(bmat, lengths, specs, nibble, *a, **kw):
            inner = real(bmat, lengths, specs, nibble, *a, **kw)

            def launch():
                inner()
                return bmat
            return launch

        monkeypatch.setattr(decode_kernel, "prepare_decode_pack", aliasing)
        found, _ = analyze_descriptor(_program("device"), "cpu")
        assert "ir-donation" in _rules(found), [f.render() for f in found]
        (f,) = [f for f in found if f.rule == "ir-donation"]
        assert f.detail == "words<-bmat"

    def test_widening_fires(self):
        """A launch that returns its words widened to int64."""
        found, _ = analyze_descriptor(
            _program("device"), "cpu",
            wrap=lambda launch: (lambda: launch().to(torch.int64)))
        assert "ir-widening" in _rules(found)
        hits = contracts.check_widening(
            [("desc", torch.zeros(4, dtype=torch.int64)),
             ("bmat", torch.zeros(4, dtype=torch.uint8))])
        assert [d for d, _ in hits] == ["desc[int64]"]

    def test_widening_clean_on_every_real_program(self):
        for desc in build_catalog(row_buckets=(64,),
                                  include_observed=False):
            found, rec = analyze_descriptor(desc, "cpu")
            assert found == [], [f.render() for f in found]
            names = {n for n, _ in rec.inputs}
            assert "desc" in names or "render_desc" in names

    def test_output_budget_fires(self):
        n_words, R = 4, 4096
        good = [torch.zeros((n_words, R), dtype=torch.int32)]
        assert contracts.check_output_budget(good, n_words, R,
                                             filtered=False) == []
        bad = good + [torch.zeros(R, dtype=torch.float32)]
        hits = contracts.check_output_budget(bad, n_words, R,
                                             filtered=False)
        assert hits and "budget" in hits[0][0]

    def test_output_budget_fires_through_the_runner(self):
        """K1 handing back one more word row than its layout has."""
        def wider(launch):
            def bad():
                words = launch()
                return torch.cat([words, words[:1]])
            return bad

        found, _ = analyze_descriptor(_program("device"), "cpu", wrap=wider)
        assert _rules(found) == ["ir-output-budget"]

    def test_output_budget_filter_metadata_allowed(self):
        n_words, R = 4, 4096
        outs = [torch.zeros((n_words, R), dtype=torch.int32),
                torch.zeros(R // 32, dtype=torch.int32),   # keep mask
                torch.zeros(1, dtype=torch.int32)]         # count
        assert contracts.check_output_budget(outs, n_words, R,
                                             filtered=True) == []
        assert contracts.check_output_budget(outs, n_words, R,
                                             filtered=False) != []

    def test_egress_output_budget_fires(self):
        """A render whose text comes back one row larger than its plan
        (the widest plan: a row outweighs the 64 B of slack)."""
        desc = max((d for d in build_catalog(row_buckets=(256,),
                                             include_observed=False)
                    if d.variant == "egress-tsv"),
                   key=lambda d: len(d.specs))

        def one_row_more(launch):
            def bad():
                text, lengths = launch()
                return torch.cat([text, text[:1]]), lengths
            return bad

        found, _ = analyze_descriptor(desc, "cpu", wrap=one_row_more)
        assert _rules(found) == ["ir-egress-output-budget"]
        (f,) = found
        assert f.detail.startswith("bytes=") and ">budget=" in f.detail

    def test_canonical_dedup_fires(self):
        """Exact specs and their reversal (no canonicalization) give
        different descriptors — the failure the contract exists for —
        and the canonical twins give identical ones."""
        from etl_tpu_torch.analysis.ir.runner import (_descriptor_bytes,
                                                      library_digest)
        from etl_tpu_torch.ops.program_store import canonical_plan

        desc = _program("host", "bool")
        specs = desc.specs
        rev = tuple(reversed(specs))
        a, b = _descriptor_bytes(specs, False), _descriptor_bytes(rev, False)
        digest = library_digest(desc)
        hits = contracts.check_canonical_dedup(a, b, digest, digest)
        assert [d for d, _ in hits] == ["permutation-descriptor-differs"]
        assert contracts.check_canonical_dedup(
            _descriptor_bytes(canonical_plan(specs).specs, False),
            _descriptor_bytes(canonical_plan(rev).specs, False),
            digest, digest, True) == []
        hits = contracts.check_canonical_dedup(a, a, digest, "other", False)
        assert [d for d, _ in hits] == ["permutation-library-differs",
                                        "permutation-words-differ"]

    def test_canonical_dedup_fires_through_the_runner(self):
        """A program whose specs are NOT canonical, with a permuted twin:
        the twin's canonical descriptor differs, and so do its words on
        the same input (launched: its specs differ)."""
        from etl_tpu_torch.analysis.ir.catalog import _decoder, \
            _device_specs, default_schemas

        exact, _ = _device_specs(_decoder(default_schemas()[1][1]))
        desc = ProgramDescriptor(tag=layout_tag(exact), specs=exact,
                                 row_capacity=64, variant="device",
                                 dedup_twin=tuple(reversed(exact)))
        found, _ = analyze_descriptor(desc, "cpu")
        dedup = [f.detail for f in found if f.rule == "ir-canonical-dedup"]
        assert "permutation-descriptor-differs" in dedup
        assert "permutation-words-differ" in dedup

    def test_collective_fires(self, monkeypatch):
        """A dispatch that calls a torch.distributed collective is
        recorded by the run's wrappers (the real op stubbed: no process
        group here), and the wrappers are taken off afterwards."""
        import torch.distributed as dist

        monkeypatch.setattr(dist, "all_reduce", lambda t, **kw: None)
        stub = dist.all_reduce

        def reducing(launch):
            def bad():
                words = launch()
                dist.all_reduce(words)
                return words
            return bad

        calls: list = []
        with recording_collectives(calls):
            assert dist.all_reduce is not stub
            found, rec = analyze_descriptor(_program("device"), "cpu",
                                            wrap=reducing, calls=calls)
        assert dist.all_reduce is stub
        assert rec.collectives == ["all_reduce"]
        assert [(f.rule, f.detail) for f in found] \
            == [("ir-collective", "all_reduce")]

    def test_findings_carry_ir_namespace_and_fingerprint(self):
        found, _ = analyze_descriptor(
            _program("device"), "cpu",
            wrap=lambda launch: (lambda: launch().to(torch.int64)))
        f = next(f for f in found if f.rule == "ir-widening")
        assert f.path.startswith(IR_NAMESPACE)
        assert f.fingerprint == f"{f.rule}|{f.path}|{f.scope}|{f.detail}"
        assert f.rule in IR_CONTRACT_NAMES
        assert f.scope == "device-r256"


# ---------------------------------------------------------------------------
# the catalogue
# ---------------------------------------------------------------------------

class TestCatalog:
    def test_variants_and_kernels(self):
        cat = build_catalog(row_buckets=(4096, 256),
                            include_observed=False)
        variants = {d.variant for d in cat}
        assert variants == {"device", "nibble", "filtered", "egress-tsv",
                            "egress-json", "host", "filtered-host"}
        assert set(KERNEL_OF_VARIANT) == variants - {"host",
                                                     "filtered-host"}
        # the filtered programs pack the exact layout, never render
        assert all(d.egress is None for d in cat if d.pred is not None)
        assert {d.row_capacity for d in cat} == {256, 4096}
        assert [(d.path, d.scope, d.source) for d in cat] == sorted(
            (d.path, d.scope, d.source) for d in cat)

    def test_tags_are_stable_hashes_of_the_specs(self):
        d = _program("device")
        assert d.tag == layout_tag(d.specs)
        assert d.tag.startswith("i32x3-") and len(d.tag) == len("i32x3-") + 8
        assert d.path == f"programs/{d.tag}"

    def test_observed_signatures_join_the_catalogue(self, monkeypatch,
                                                    tmp_path):
        """What the engine's dispatch records (`record_observed`) is
        re-verified: an unfiltered device key becomes a program of its
        route; a filtered key (its filter cannot be rebuilt from a
        fingerprint) and a malformed key are skipped."""
        from etl_tpu_torch.ops import program_store

        monkeypatch.setattr(program_store, "_CONFIGURED", [str(tmp_path)])
        program_store.reset_for_tests()
        specs = _program("device").specs
        program_store.record_observed((1024, specs, True, None, None,
                                       "device"))
        program_store.record_observed((1024, specs, False, None, ("f",),
                                       "device"))
        program_store.record_observed((512, specs, False, None, None,
                                       "host"))
        observed = [d for d in build_catalog(row_buckets=(256,))
                    if d.source == "observed"]
        assert [(d.variant, d.row_capacity, d.nibble)
                for d in observed] == [("host", 512, False),
                                       ("nibble", 1024, True)]
        program_store.reset_for_tests()

    def test_corrupt_observed_file_degrades_to_the_schema_catalogue(
            self, monkeypatch, tmp_path):
        from etl_tpu_torch.ops import program_store

        monkeypatch.setattr(program_store, "_CONFIGURED", [str(tmp_path)])
        path = Path(program_store._observed_path(str(tmp_path)))
        path.parent.mkdir(parents=True)
        path.write_bytes(b"not a pickle")
        cat = build_catalog(row_buckets=(256,))
        assert cat and all(d.source == "schema" for d in cat)
        assert not path.exists()

    def test_observed_programs_run_clean(self, monkeypatch, tmp_path):
        from etl_tpu_torch.ops import program_store

        monkeypatch.setattr(program_store, "_CONFIGURED", [str(tmp_path)])
        path = Path(program_store._observed_path(str(tmp_path)))
        path.parent.mkdir(parents=True)
        specs = _program("device").specs
        path.write_bytes(pickle.dumps({
            "format": program_store._CACHE_FORMAT_VERSION,
            "keys": [(128, specs, False, None, "device")]}))
        found, paths, report = analyze_local(device="cpu",
                                             row_buckets=(64,))
        assert found == [] and report["programs"] == len(
            build_catalog(row_buckets=(64,)))
        assert f"programs/{layout_tag(specs)}" in paths


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------

class TestDeterminism:
    def test_single_device_pass_is_byte_identical(self):
        runs = []
        for _ in range(2):
            findings, paths, report = analyze_local(
                device="cpu", row_buckets=(256,), include_observed=False)
            runs.append((json.dumps([f.to_dict() for f in findings],
                                    sort_keys=True), tuple(paths),
                         report["variants"], report["routes"]))
        assert runs[0] == runs[1]
        a = [(d.path, d.scope) for d in build_catalog(
            row_buckets=(256,), include_observed=False)]
        b = [(d.path, d.scope) for d in build_catalog(
            row_buckets=(256,), include_observed=False)]
        assert a == b and a == sorted(a)

    def test_violating_findings_are_byte_identical(self):
        """The same deliberate violations twice: the same findings JSON
        (fingerprints, messages, order)."""
        def widen(launch):
            return lambda: launch().to(torch.int64)

        dumps = []
        for _ in range(2):
            found = []
            for variant in ("device", "nibble"):
                got, _ = analyze_descriptor(_program(variant), "cpu",
                                            wrap=widen)
                found += got
            dumps.append(json.dumps([f.to_dict() for f in found]))
        assert dumps[0] == dumps[1] and "ir-widening" in dumps[0]


# ---------------------------------------------------------------------------
# CLI wiring + cross-tier baseline staleness
# ---------------------------------------------------------------------------

class TestCliWiring:
    def test_list_rules_with_programs_includes_contracts(self, capsys):
        from etl_tpu_torch.analysis.cli import main

        assert main(["--list-rules", "--programs"]) == 0
        assert set(IR_CONTRACT_NAMES) <= set(capsys.readouterr().out.split())
        assert main(["--list-rules", "--ir"]) == 0
        assert set(IR_CONTRACT_NAMES) <= set(capsys.readouterr().out.split())

    def test_mesh_without_programs_exits_two(self, capsys):
        from etl_tpu_torch.analysis.cli import main

        assert main(["--mesh"]) == 2
        assert "--mesh requires --programs" in capsys.readouterr().err

    def test_programs_mesh_on_the_cpu_lists_the_four_variants_clean(
            self, tmp_path, capsys):
        """`--programs --mesh --device cpu`: the single-device set and
        the mesh's four variants on 8 CPU shards, in one process, every
        contract 0, exit 0."""
        from etl_tpu_torch.analysis.cli import main

        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        assert main(["--programs", "--mesh", "--device", "cpu",
                     "--row-buckets", "256", "--json", str(clean)]) == 0
        report = json.loads(capsys.readouterr().out)["programs"]
        assert report["mesh_shards"] == 8
        mesh = {k: v for k, v in report["variants"].items()
                if k.startswith("mesh")}
        assert set(mesh) == {"mesh", "mesh-filtered", "mesh-egress-tsv",
                             "mesh-egress-json"}
        assert report["findings"] == {name: 0 for name in IR_CONTRACT_NAMES}
        assert {"mesh-k1-plain", "mesh-filtered-plain",
                "mesh-render-plain"} <= set(report["routes"])

    def test_cross_block_read_fires_ir_collective(self):
        """A mesh program whose second shard's launch reads the first
        shard's block (re-prepared over its inputs): `ir-collective`
        names the two shards' overlapping tensors, and nothing else
        fires."""
        from etl_tpu_torch.ops import decode_kernel
        from etl_tpu_torch.parallel.mesh import shard_mesh

        desc = next(d for d in build_catalog(
            mesh=shard_mesh(8, "cpu"), row_buckets=(256,),
            include_observed=False)
            if d.variant == "mesh" and d.tag.startswith("i32x3"))
        seen = []

        def wrap(launch):
            seen.append(launch)
            if len(seen) == 2:
                return decode_kernel.prepare_decode_pack(
                    *seen[0].inputs, desc.specs, desc.nibble)
            return launch

        found, _ = analyze_descriptor(desc, "cpu", wrap=wrap)
        assert set(_rules(found)) == {"ir-collective"}
        details = {f.detail for f in found}
        assert "shard0.in:bmat~shard1.in:bmat" in details
        assert "shard0.in:lengths~shard1.in:lengths" in details
        clean, _ = analyze_descriptor(desc, "cpu")
        assert clean == []

    def test_device_cuda_without_a_card_exits_two(self, tmp_path):
        """No card, `--device cuda` (the default): exit 2 before any
        scan, nothing on stdout — the tier never drops to the CPU."""
        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
        for argv in (["--programs"], ["--ir", "--device", "cuda"]):
            proc = subprocess.run(
                [sys.executable, "-m", "etl_tpu_torch.analysis", *argv,
                 str(clean)], capture_output=True, text=True, timeout=300,
                cwd=REPO, env=env)
            assert proc.returncode == 2, proc.stderr
            assert proc.stdout == ""
            assert "NO_CUDA_DEVICE" in proc.stderr

    def test_programs_on_the_cpu_lists_what_it_could_not_check(
            self, tmp_path, capsys):
        from etl_tpu_torch.analysis.cli import main

        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        assert main(["--ir", "--device", "cpu", "--row-buckets", "64",
                     "-q", str(clean)]) == 0
        err = capsys.readouterr().err
        assert "ir-host-callback not_checked: cpu" in err
        assert main(["--programs", "--device", "cpu", "--row-buckets",
                     "64", "--json", str(clean)]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["violations"] == []
        assert doc["programs"]["not_checked"] == {"ir-host-callback": "cpu"}
        assert doc["programs"]["row_buckets"] == [64]

    def test_bad_row_buckets_exit_two(self, capsys):
        from etl_tpu_torch.analysis.cli import main

        assert main(["--programs", "--device", "cpu", "--row-buckets",
                     "0"]) == 2
        capsys.readouterr()

    def test_two_cli_runs_give_byte_identical_findings_json(
            self, tmp_path, capsys):
        from etl_tpu_torch.analysis.cli import main

        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        outs = []
        for _ in range(2):
            assert main(["--programs", "--device", "cpu", "--row-buckets",
                         "64", "--json", str(clean)]) == 0
            doc = json.loads(capsys.readouterr().out)
            outs.append(json.dumps(doc["findings"], sort_keys=True))
        assert outs[0] == outs[1]

    def test_stale_ir_baseline_entry_reported(self, tmp_path, capsys,
                                              monkeypatch):
        """A baseline entry in the programs/ namespace that no tier can
        produce any more surfaces as stale when the IR tier runs — and
        stays out of scope when it does not."""
        from etl_tpu_torch.analysis import cli
        from etl_tpu_torch.analysis.ir import runner as ir_runner

        baseline = tmp_path / "baseline.json"
        baseline.write_text(json.dumps({
            "version": 1,
            "entries": {
                "ir-host-callback|programs/gone-00000000|device-r4096|"
                "sync@ops/x.py:probe": {"count": 1},
            },
        }))
        clean = tmp_path / "clean.py"
        clean.write_text("x = 1\n")
        monkeypatch.setattr(
            ir_runner, "analyze_local",
            lambda device="cuda", row_buckets=None:
                ([], ["programs/elsewhere-11111111"],
                 {"not_checked": {}, "programs": 0, "device": device,
                  "row_buckets": [4096], "seconds": 0.0, "variants": {},
                  "launches": {}, "routes": {}, "findings": {}}))
        rc = cli.main(["--check-baseline", "--programs", "--device", "cpu",
                       "--baseline", str(baseline), str(clean)])
        out = capsys.readouterr().out
        assert rc == 1
        assert "programs/gone-00000000" in out
        rc = cli.main(["--check-baseline", "--baseline", str(baseline),
                       str(clean)])
        assert rc == 0
