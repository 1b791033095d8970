"""The ``kernels`` and ``roofline`` suites (``repro_torch/bench/
kernel_bench.py``, ``bench/roofline_table.py``) against the reference's
``benchmarks/kernel_bench.py`` and ``benchmarks/roofline_table.py``, on
the CPU.

The quick grid prints the reference's row names letter for letter and its
byte and wire figures exactly; the reference's ``tpu_*`` projections are
the port's ``h100_*`` bounds from ``roofline.kernel_cost``; every row
besides the byte counts has a time, and the rows that time a plain
function where the reference times XLA say so.  The roofline table reads
the dry-run's artifacts as the reference's does, row for row.  The
reference's suite runs once (quick), ~12 s of jit compiles.
"""
import importlib

import pytest
import torch
from test_torch_reference import reference  # noqa: F401

from repro_torch.bench import kernel_bench, roofline_table, run
from repro_torch.launch import dryrun
from repro_torch.roofline import kernel_cost as kc

TIME_KEYS = ("dense_us", "f32_us", "materialized_us", "plain_us")


def parse(line):
    name, us, derived = line.split(",", 2)
    items = dict(kv.split("=", 1) for kv in derived.split(";")) \
        if "=" in derived else {}
    return name, float(us), items


@pytest.fixture(scope="module")
def quick_rows(reference):
    ref_kb = importlib.import_module("benchmarks.kernel_bench")
    return ([parse(r) for r in ref_kb.main(quick=True)],
            kernel_bench.rows(quick=True, device="cpu"))


def test_quick_rows_are_the_references_names_and_bytes(quick_rows):
    ref_rows, rows = quick_rows
    assert [r.name for r in rows] == [name for name, _, _ in ref_rows]
    for (name, _, want), row in zip(ref_rows, rows):
        _, us, got = parse(row.line())
        for key, value in want.items():
            if key.startswith("tpu_"):
                assert "h100_" + key[len("tpu_"):] in got, (name, key)
            elif key not in TIME_KEYS:
                assert got[key] == value, (name, key)      # bytes, ratios
            else:
                assert float(got[key]) > 0.0, (name, key)
        assert (us > 0.0) == (not name.startswith("kernel/sign_wire"))
        assert ("timed" in got) == (name.startswith(("kernel/dual_wire",
                                                     "kernel/streamed")))
        assert ("plain_us" in got) == (row.bound_us is not None)


def test_quick_rows_carry_the_kernel_cost_bounds(quick_rows):
    _, rows = quick_rows
    by = {r.name.split("_C")[0].split("_B")[0].split("_L")[0]
          .split("_S")[0]: r for r in rows}
    z, W = torch.empty(200_000, device="meta"), torch.empty(
        16, 200_000, device="meta")
    assert by["kernel/sign_agg"].bound_us == pytest.approx(
        kc.bound_ms(kc.sign_agg_work(z, W))[0] * 1e3)
    q, k = torch.empty(1, 256, 4, 64, device="meta"), torch.empty(
        1, 256, 2, 64, device="meta")
    assert by["kernel/flash_attn"].bound_us == pytest.approx(
        kc.flash_work(q, k, True, 0).t_ops * 1e6)
    # the CPU runs the plain versions: no kernel launched
    assert all(r.launches == 0 for r in rows)


def test_the_suites_run_through_the_runner_on_the_cpu(tmp_path, capsys,
                                                     monkeypatch):
    monkeypatch.setattr(roofline_table, "OUT_DIR", str(tmp_path))
    assert run.main(["--only", "roofline", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[1].startswith(
        "roofline/none,0.0,run `python -m repro_torch.launch.dryrun")
    dryrun.run_one("smollm-360m", "decode_32k", out_dir=str(tmp_path),
                   verbose=False, smoke=True)
    assert run.main(["--only", "roofline", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("roofline/smollm-360m/decode_32k/1x1,")


def test_roofline_table_reads_the_artifacts_as_the_reference(
        reference, tmp_path, monkeypatch):
    ref_rt = importlib.import_module("benchmarks.roofline_table")
    for arch, shape in (("smollm-360m", "prefill_32k"),
                        ("hymba-1.5b", "train_4k")):
        dryrun.run_one(arch, shape, out_dir=str(tmp_path), verbose=False,
                       smoke=True)
    for mod in (ref_rt, roofline_table):
        monkeypatch.setattr(mod, "OUT_DIR", str(tmp_path))
    rows = roofline_table.rows_from_artifacts()
    assert len(rows) == 2 and rows == ref_rt.rows_from_artifacts()
    assert roofline_table.format_table(rows) == ref_rt.format_table(rows)
    assert roofline_table.main() == ref_rt.main()
