"""The port's H100 roofline (``repro_torch/roofline/``) against the JAX
package's ``roofline/``, on the CPU.

* ``model_flops_for`` is the reference's for the ten configs x four shapes;
  ``RooflineReport`` fed the same numbers gives the reference's terms and
  row, only ``Hardware`` differing.
* ``cost.CostCounter`` counts a Python loop of N products N times, a
  storage once however many views it has, and frees it when its last
  reference dies.
* ``kernel_cost`` is pinned to ``PERF.md`` section 6's bound column.
* Each kernel wrapper's ``meta`` branch applies the card's checks,
  launches nothing, leaves ``LAUNCHES`` as it is and adds its work.
* On SmolLM's smoke prefill and decode steps the port's dot FLOPs outside
  attention agree with the reference's compiled program's
  (``hlo_parse.totals``) within 1 %, and the attention FLOPs are the
  reference's times kept pairs / (Sq Sk): B4 skips what its mask removes.
"""
import dataclasses
import importlib

import pytest
import torch
from test_torch_reference import reference  # noqa: F401

from repro_torch.configs import ARCHS, INPUT_SHAPES, get_arch, reduce_for_smoke
from repro_torch.kernels import decode_attention as dec_k
from repro_torch.kernels import flash_attention as fa_k
from repro_torch.kernels import sign_agg as sa
from repro_torch.kernels import ssm_scan as ssm_k
from repro_torch.roofline import analysis, cost, kernel_cost as kc

META = "meta"


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


@pytest.fixture(scope="module")
def ref_roofline():
    """The reference's roofline modules (they import no ``repro.core``)."""
    return (importlib.import_module("repro.roofline.analysis"),
            importlib.import_module("repro.roofline.hlo_parse"))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_for_matches_reference(reference, ref_roofline, arch):
    ref_an, _ = ref_roofline
    for name, shape in INPUT_SHAPES.items():
        want = ref_an.model_flops_for(reference.configs.get_arch(arch),
                                      reference.configs.INPUT_SHAPES[name])
        assert analysis.model_flops_for(get_arch(arch), shape) == want, name


def test_report_fed_the_same_numbers_gives_the_reference_terms(ref_roofline):
    ref_an, _ = ref_roofline
    fields = dict(arch="a", shape="s", mesh="m", chips=4, flops=3.1e15,
                  dot_flops=2.9e15, hbm_bytes=7.3e11,
                  hbm_op_bytes_upper=9.9e12, collective_bytes=2.2e10,
                  collectives={"all-reduce": 2.2e10}, xla_flops=1.0e14,
                  xla_bytes=3.0e11, bytes_per_device=1.2e10,
                  argument_bytes=4e9, output_bytes=3e9, temp_bytes=5e9,
                  model_flops=8.8e15)
    want = ref_an.RooflineReport(**fields).finalize(ref_an.V5E).row()
    v5e = analysis.Hardware(**dataclasses.asdict(ref_an.V5E))
    got = analysis.RooflineReport(**fields).finalize(v5e).row()
    assert got == want
    h100 = analysis.RooflineReport(**fields).finalize(analysis.H100)
    assert list(h100.row()) == list(want)
    assert h100.t_compute == fields["flops"] / kc.BF16_FLOPS_PER_S
    assert h100.t_memory == fields["hbm_bytes"] / kc.HBM_BYTES_PER_S
    # per rate class: the f32 products at 67 TFLOP/s, 3xTF32 at a third
    # of 494.7, bf16 at 989
    by = analysis.RooflineReport(
        **fields, flops_by_class={"f32": 67e12, "tf32x3": 494.7e12,
                                  "bf16": 989e12}).finalize(analysis.H100)
    assert by.t_compute == pytest.approx(1.0 + 3.0 + 1.0, rel=1e-12)


def test_a_loop_of_n_products_counts_n_times_2mnk():
    m, k, n, N = 8, 16, 4, 7
    a, b = meta(m, k), meta(k, n)
    with cost.CostCounter((a, b)) as c:
        out = a
        for _ in range(N):
            out = torch.mm(a, b)
        torch.bmm(meta(3, m, k, dtype=torch.bfloat16),
                  meta(3, k, n, dtype=torch.bfloat16))
    assert c.dot_flops == N * 2 * m * n * k + 3 * 2 * m * n * k
    assert c.flops_by_class["bf16"] == 3 * 2 * m * n * k
    assert c.flops_by_class["f32"] == N * 2 * m * n * k + c.elem_flops
    assert out.shape == (m, n)


def test_memory_counts_a_storage_once_and_frees_it_at_its_last_reference():
    x = meta(1000)                              # an argument: not the step's
    with cost.CostCounter((x,)) as c:
        y = x * 2                               # 4000 B -> 4096
        views = [y.view(10, 100), y[:5], y.reshape(100, 10)]
        z = y + 1
        assert c.live_bytes == 2 * 4096
        del y, z
        assert c.live_bytes == 4096             # the views keep y's storage
        del views
        w = torch.empty(0, device=META)
    assert c.live_bytes == 0 and c.peak_bytes == 2 * 4096
    assert c.argument_bytes == 4096
    assert c.output_bytes(w) == 0 and c.output_bytes(x) == 0


def test_kernel_cost_pins_the_perf_md_bounds():
    """``PERF.md`` section 6's bound column, from the formulas now in
    ``kernel_cost`` (they were ``chip_smoke.py``'s)."""
    q, k = meta(4, 4096, 15, 64), meta(4, 4096, 5, 64)
    ms, by = kc.bound_ms(kc.flash_work(q, k, True, 0))
    assert round(ms, 6) == 0.781567 and by == "operations"
    q5, k5 = meta(8, 15, 64), meta(8, 4096, 5, 64)
    length = torch.full((8,), 4096, dtype=torch.int32)
    assert kc.valid_positions(length, 4096) == 8 * 4096
    assert kc.valid_positions(length, 1024) == 8 * 1024
    assert round(kc.bound_ms(kc.decode_work(q5, k5, 8 * 4096))[0],
                 6) == 0.025059
    a, h0 = meta(4, 128, 1600, 16), meta(4, 1600, 16)
    assert kc.bound_ms(kc.scan_work(a, h0)) == (
        pytest.approx(0.047073, abs=5e-7), "bytes")
    assert kc.kept_pairs(4, 8, True, 0) == 5 + 6 + 7 + 8
    assert kc.kept_pairs(4, 8, True, 2) == 8
    assert kc.kept_pairs(4, 8, False, 0) == 32


def _launches():
    return {**sa.LAUNCHES, **fa_k.LAUNCHES, **dec_k.LAUNCHES,
            **ssm_k.LAUNCHES}


def test_meta_branches_count_work_and_launch_nothing():
    before = _launches()
    C, D = 6, 40
    z, W, phi = meta(D), meta(C, D), meta(D)
    w = meta(C)
    q, kk = meta(2, 32, 4, 64), meta(2, 32, 2, 64)
    q5, k5 = meta(2, 4, 64), meta(2, 48, 2, 64)
    a, h0 = meta(2, 16, 8, 4), meta(2, 8, 4)
    with cost.CostCounter() as c:
        outs = sa.sign_agg_group([z, z], [W, W], [phi, phi], w, 0.1, 0.1)
        sa.sign_agg_int8_group([z], [meta(C, D, dtype=torch.int8)], [phi],
                               None, 0.1, 0.1)
        sa.sign_agg(z, W, phi, 0.1, 0.1)
        o = fa_k.flash_attention(q, kk, kk, causal=True)
        dq, dk, dv = fa_k.flash_attention_bwd(
            q, kk, kk, o, meta(2, 4, 32), o, causal=True)
        o5 = dec_k.decode_attention(q5, k5, k5,
                                    torch.empty(2, dtype=torch.int32,
                                                device=META))
        hs = ssm_k.ssm_scan(a, a, h0)
        da, db, dh0 = ssm_k.ssm_scan_bwd(a, hs, h0, hs)
    assert _launches() == before
    assert [t.shape for t in outs] == [(D,), (D,)]
    assert (o.shape, dq.shape, dk.shape, o5.shape, hs.dtype, dh0.shape) == (
        q.shape, q.shape, kk.shape, q5.shape, torch.float32, h0.shape)
    ks = c.kernels
    assert ks["sign_agg_weighted"].flops == 2 * 3 * C * D
    assert ks["sign_agg_weighted"].launches == 1
    assert ks["sign_agg_weighted_int8"].flops == C * D
    assert ks["sign_agg"].flops == 2 * C * D
    assert ks["flash_attention"].flops == kc.flash_flops(q, kk, True, 0)
    assert ks["flash_attention"].rate == "tf32x3"
    assert ks["flash_attention_bwd"].launches == fa_k.BWD_LAUNCHES
    assert ks["flash_attention_bwd"].flops == kc.bwd_flops(q, kk, True, 0)
    assert ks["decode_attention"].nbytes == kc.decode_work(q5, k5,
                                                           2 * 48).nbytes
    assert ks["ssm_scan"].nbytes == kc.scan_work(a, h0).nbytes
    assert ks["ssm_scan_bwd"].flops == 3 * a.numel()


def test_meta_branches_apply_the_cards_checks():
    # under autograd B4 takes the forward's head dims (128 here) and
    # refuses the others before anything runs
    q = meta(1, 16, 2, 128, dtype=torch.float32).requires_grad_()
    k = meta(1, 16, 1, 128).requires_grad_()
    assert fa_k.flash_attention(q, k, k).shape == q.shape
    with pytest.raises(ValueError, match="backward takes head dim"):
        fa_k.flash_attention(meta(1, 16, 2, 96).requires_grad_(),
                             meta(1, 16, 1, 96), meta(1, 16, 1, 96))
    with pytest.raises(ValueError, match="head dim 32 not supported"):
        fa_k.flash_attention(meta(1, 8, 2, 32), meta(1, 8, 1, 32),
                             meta(1, 8, 1, 32))
    q5 = meta(2, 4, 64).requires_grad_()
    with pytest.raises(NotImplementedError, match="B5"):
        dec_k.decode_attention(q5, meta(2, 8, 2, 64), meta(2, 8, 2, 64),
                               torch.empty(2, dtype=torch.int32,
                                           device=META))
    with pytest.raises(TypeError):
        sa.sign_agg(meta(4, dtype=torch.float64), meta(2, 4, dtype=torch.
                                                       float64),
                    meta(4, dtype=torch.float64), 0.1, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ssm_k.ssm_scan(meta(2, 8, 4, 3).transpose(1, 2),
                       meta(2, 8, 4, 3).transpose(1, 2))


# ---------------------------------------------------------------------------
# the port's count against the reference's compiled program
@pytest.fixture(scope="module")
def smoke_steps(reference, ref_roofline):
    """SmolLM's smoke prefill and decode steps: the port's counter on
    meta, the reference's ``hlo_parse`` totals of its compiled step (each
    compiled once)."""
    import jax
    import jax.numpy as jnp

    from repro_torch.launch import dryrun

    _, hlo = ref_roofline
    rsteps = importlib.import_module("repro.launch.steps")
    rtr = importlib.import_module("repro.models.transformer")
    rcfg = reference.configs.reduce_for_smoke(
        reference.configs.get_arch("smollm-360m"))
    cfg = reduce_for_smoke(get_arch("smollm-360m"))
    out = {}
    for name in ("prefill_32k", "decode_32k"):
        shape = dataclasses.replace(INPUT_SHAPES[name], seq_len=64,
                                    global_batch=4)
        rshape = dataclasses.replace(reference.configs.INPUT_SHAPES[name],
                                     seq_len=64, global_batch=4)
        p_sds = rsteps.params_struct(rcfg)
        if shape.kind == "prefill":
            def fn(p, i, rcfg=rcfg):
                x, _ = rtr.forward(p, i, rcfg)
                from repro.models.layers import lm_logits
                return lm_logits(p["embed"], x[:, -1:], rcfg)[:, 0]
            rargs = (p_sds, rsteps.prefill_inputs_struct(rcfg, rshape))
        else:
            st = jax.eval_shape(lambda: rtr.init_decode_state(
                rcfg, 4, 64, jnp.float32))

            def fn(p, s, t, rcfg=rcfg):
                return rtr.decode_step(p, s, t, 63, rcfg)
            rargs = (p_sds, st, jax.ShapeDtypeStruct((4, 1), jnp.int32))
        text = jax.jit(fn).lower(*rargs).compile().as_text()
        ref_dot = hlo.totals(text).dot_flops
        row = dryrun.run_one("smollm-360m", name, out_dir="", verbose=False,
                             smoke=True)
        out[name] = (cfg, shape, ref_dot, row)
    return out


@pytest.mark.parametrize("name", ["prefill_32k", "decode_32k"])
def test_dot_flops_match_the_reference_outside_attention(smoke_steps, name):
    cfg, shape, ref_dot, row = smoke_steps[name]
    B, S = shape.global_batch, shape.seq_len
    H, D = cfg.n_heads, cfg.resolved_head_dim
    sq = S if shape.kind == "prefill" else 1
    # the reference's XLA attention: QK^T and PV over every (query, key)
    ref_attn = cfg.n_layers * 4 * B * H * sq * S * D
    assert row["dot_flops"] == pytest.approx(ref_dot - ref_attn, rel=0.01)
    kernel = "flash_attention" if shape.kind == "prefill" \
        else "decode_attention"
    kept = (kc.kept_pairs(S, S, True, 0) if shape.kind == "prefill"
            else S)           # decode at the last position: every slot
    assert row["kernels"][kernel]["flops"] == ref_attn * kept / (sq * S)
    assert row["kernels"][kernel]["launches"] == cfg.n_layers
