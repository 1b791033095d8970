"""The port's dry-run (``repro_torch/launch/dryrun.py``) on the CPU, at
smoke width: its artifact holds the reference's row keys (read from the
reference's ``launch/dryrun.py`` source, which cannot be imported in a
test process: it sets a 512-device XLA flag) plus ``fits`` and the FLOPs
per rate class; a meta pass launches no kernel and allocates nothing
O(C) or O(params); the production meshes raise naming ROADMAP 7(b); a
variant's ``fed_patch`` and ``inner_dp`` apply; the sweep lists a failing
row and exits 1."""
import ast
import dataclasses
import json
import os

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import INPUT_SHAPES, get_arch, reduce_for_smoke
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import sign_agg as sa
from repro_torch.kernels import ssm_scan as ssm_k
from repro_torch.launch import dryrun, steps
from repro_torch.models import layers
from repro_torch.roofline import kernel_cost as kc

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_row_keys():
    """The keys of the reference's artifact: ``RooflineReport.row()``'s
    and those ``run_one`` adds (``row.update({...})``), from the sources."""
    keys = set()
    for rel in ("src/repro/roofline/analysis.py",
                "src/repro/launch/dryrun.py"):
        with open(os.path.join(REPO_ROOT, rel)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name == "row":
                ret = [n for n in ast.walk(node) if isinstance(n, ast.Return)]
                keys |= {k.value for k in ret[0].value.keys}
            if (isinstance(node, ast.Call) and isinstance(node.func,
                                                          ast.Attribute)
                    and node.func.attr == "update"):
                keys |= {k.value for k in node.args[0].keys}
    return keys


def _launches():
    return {**sa.LAUNCHES, **fa_k.LAUNCHES, **dec_k.LAUNCHES,
            **ssm_k.LAUNCHES}


@pytest.mark.parametrize("shape", sorted(INPUT_SHAPES))
def test_run_one_writes_the_reference_keys_fits_and_classes(tmp_path,
                                                             shape):
    before = _launches()
    row = dryrun.run_one("hymba-1.5b", shape, out_dir=str(tmp_path),
                         verbose=False, smoke=True)
    assert _launches() == before                 # nothing launched
    path = tmp_path / f"hymba-1.5b__{shape}__1x1.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(row))
    ref_keys = reference_row_keys()
    assert len(ref_keys) == 23 and ref_keys <= set(row)
    assert {"fits", "flops_by_class"} <= set(row) and row["fits"] is True
    assert set(row["flops_by_class"]) == {"f32", "tf32x3", "bf16"}
    assert row["mesh"] == "1x1" and row["chips"] == 1
    assert row["flops"] == pytest.approx(sum(row["flops_by_class"]
                                             .values()))
    assert row["bytes_per_device"] == (row["memory_analysis"]
                                       ["argument_size_in_bytes"]
                                       + row["memory_analysis"]
                                       ["output_size_in_bytes"]
                                       + row["memory_analysis"]
                                       ["temp_size_in_bytes"])
    want = {"train_4k": {"flash_attention", "flash_attention_bwd",
                         "ssm_scan", "ssm_scan_bwd", "sign_agg"},
            "prefill_32k": {"flash_attention", "ssm_scan"}}.get(
        shape, {"decode_attention"})
    assert set(row["kernels"]) == want
    assert row["t_compute_s"] > 0 and row["t_memory_s"] > 0
    assert row["t_collective_s"] == 0


class DeviceLog(TorchDispatchMode):
    """Every tensor an op makes off the meta device: (op, numel)."""

    def __init__(self):
        super().__init__()
        self.off_meta = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor) and t.device.type != "meta":
                self.off_meta.append((str(func), t.numel()))
        return out


def test_a_meta_pass_allocates_nothing_of_the_fleet_or_the_params():
    """A round of 40 smoke-width SmolLM clients, one sequence each, on
    meta: nothing leaves the meta device but scalars and RoPE's 32
    frequencies (computed on the host, trap AJ), and the state counted is
    the fleet's (3C + 1 trees)."""
    C = 40
    log = DeviceLog()
    with log:
        row = dryrun.run_one("smollm-360m", "train_4k", out_dir="",
                             verbose=False, smoke=True,
                             cut=dict(global_batch=C), n_clients=C)
    assert max((n for _, n in log.off_meta), default=0) <= 32
    assert row["n_clients"] == C and row["cut"] == {"global_batch": C}
    # the peak leaves out the per-device caches, warm or cold before
    layers._rope_freqs_on.cache_clear()
    cold = dryrun.run_one("smollm-360m", "train_4k", out_dir="",
                          verbose=False, smoke=True,
                          cut=dict(global_batch=C), n_clients=C)
    assert cold["bytes_per_device"] == row["bytes_per_device"]
    n_params = reduce_for_smoke(get_arch("smollm-360m")).n_params()
    assert row["memory_analysis"]["argument_size_in_bytes"] >= \
        (3 * C + 1) * 4 * n_params
    assert row["kernels"]["sign_agg"]["launches"] == 1


@pytest.mark.parametrize("multi_pod,flag", [(False, "single"),
                                            (True, "multi")])
def test_the_production_meshes_raise_naming_7b(multi_pod, flag):
    with pytest.raises(NotImplementedError, match="7\\(b\\)"):
        dryrun.run_one("smollm-360m", "train_4k", multi_pod, out_dir="",
                       smoke=True)
    with pytest.raises(NotImplementedError, match="7\\(b\\)"):
        dryrun.main(["--arch", "smollm-360m", "--shape", "train_4k",
                     "--smoke", "--multi-pod", flag])


def test_a_variant_applies_its_fed_patch_and_inner_dp(monkeypatch):
    """``inner_dp+signs8`` sends the round's signs on the int8 wire (B3,
    not B1) and plans inner data parallelism; the launcher would apply
    its cfg_patch only."""
    seen = {}
    real = steps.input_specs

    def spy(cfg, shape, mesh, base_fed=None, inner_dp=False,
            n_clients=None):
        seen.update(fed=base_fed, inner_dp=inner_dp)
        return real(cfg, shape, mesh, base_fed=base_fed, inner_dp=inner_dp,
                    n_clients=n_clients)

    monkeypatch.setattr(steps, "input_specs", spy)
    row = dryrun.run_one("smollm-360m", "train_4k", out_dir="",
                         verbose=False, smoke=True, variant="inner_dp+signs8")
    assert seen["inner_dp"] is True and seen["fed"].sign_message == "int8"
    assert row["arch"] == "smollm-360m+inner_dp+signs8"
    assert "sign_agg_weighted_int8" in row["kernels"]
    assert "sign_agg" not in row["kernels"]


def test_the_sweep_lists_a_failing_row_and_exits_1(capsys, tmp_path):
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                        "--smoke", "--out", str(tmp_path)]) == 0
    assert "All dry-runs ran." in capsys.readouterr().out
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                        "--smoke", "--variant", "nope", "--out",
                        str(tmp_path)]) == 1
    out = capsys.readouterr().out
    assert "1 FAILURES:" in out and "'nope'" in out


def test_the_card_refuses_what_the_dry_run_refuses():
    """B4's backward takes the forward's head dims (64, 128, 256): a
    training row at another head dim raises on meta as on the card."""
    def setup(cfg, shape, mesh):
        cfg = dataclasses.replace(reduce_for_smoke(get_arch("gemma-7b")),
                                  head_dim=96)
        return steps.input_specs(cfg, shape, mesh)

    with pytest.raises(ValueError, match="backward takes head dim"):
        dryrun.run_one("gemma-7b", "train_4k", out_dir="", verbose=False,
                       smoke=True, setup_override=setup)


@pytest.mark.parametrize("arch", ["gemma-7b", "olmoe-1b-7b"])
def test_a_train_row_at_the_familys_head_dim_counts_b4s_backward(arch):
    """``train_4k`` of the 2-layer smoke model with the family's own head
    dim restored (Gemma-7B 256, OLMoE 128) on meta: B4's backward is
    counted, once per attention layer and client, as
    ``kernel_cost.flash_bwd_work`` of the call's shapes (BWD_LAUNCHES
    launches each), and nothing launches."""
    hd = get_arch(arch).resolved_head_dim

    def setup(cfg, shape, mesh):
        return steps.input_specs(dataclasses.replace(cfg, head_dim=hd),
                                 shape, mesh)

    before = _launches()
    row = dryrun.run_one(arch, "train_4k", out_dir="", verbose=False,
                         smoke=True, setup_override=setup)
    assert _launches() == before
    cfg, shape = dryrun.smoke_case(get_arch(arch), INPUT_SHAPES["train_4k"])
    calls = cfg.n_layers          # one client, remat off in the smoke cut
    q = torch.empty((shape.global_batch, shape.seq_len, cfg.n_heads, hd),
                    device="meta")
    k = torch.empty((shape.global_batch, shape.seq_len, cfg.n_kv_heads, hd),
                    device="meta")
    want = kc.flash_bwd_work(q, k, True, 0)
    got = row["kernels"]["flash_attention_bwd"]
    assert got["launches"] == calls * fa_k.BWD_LAUNCHES
    assert got["flops"] == calls * want.flops
    assert got["nbytes"] == calls * want.nbytes
    assert row["kernels"]["flash_attention"]["launches"] == calls
