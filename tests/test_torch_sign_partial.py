"""B1-B3 split for a round over ranks: the plain versions of the partial
(``ref.sign_sum_group_ref``, ``ref.sign_sum_int8_group_ref``) and of the
finish (``ref.sign_finish_group_ref``), which the wrappers run on the
CPU, against the fused plain versions (``sign_agg_group_ref``,
``sign_agg_int8_group_ref``), the all-reduce played by summing the
blocks' partials here.

Unweighted, finish(sum of partials) equals the fused fold bit for bit,
for 1, 2 and 4 row blocks, NaN rows and -0.0 included (trap A): every
partial is a sum of signs, an integer below 2^24 in f32 (int32 on the
int8 wire), so any grouping is exact.  Weighted (B2, B3 weighted), the
blocks regroup the fold: z' stays within ``ref.weighted_split_bound``,
stated before the first run (each of the two sums of C terms within
(C - 1) u sum |s_i| of the exact one, u = 2^-24, then the epilogue's
roundings).  On ``meta`` the wrappers count the kernels' work and launch
nothing.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sign_agg as sa
from repro_torch.roofline.cost import CostCounter

C = 16
SIZES = [128, 2816, 5, 1024, 33, 8]
PSI, ALPHA = 0.7, 0.1


def _leaves(seed, dtype=torch.float32, ties=True):
    g = torch.Generator().manual_seed(seed)
    zs = [torch.randn(D, generator=g).to(dtype) for D in SIZES]
    Ws = [torch.randn(C, D, generator=g).to(dtype) for D in SIZES]
    phis = [torch.randn(D, generator=g) for D in SIZES]
    if ties:
        Ws[0][:, 3] = zs[0][3]             # every row ties z
        Ws[1][5, 7] = float("nan")         # a NaN row entry
        zs[2][1] = -0.0                    # -0.0 against +0.0 rows
        Ws[2][:, 1] = 0.0
        Ws[3][:8, 0] = zs[3][0]            # half the rows tie
    return zs, Ws, phis


def _bits(a, b):
    return a.contiguous().view(torch.uint8).numpy().tobytes() == \
        b.contiguous().view(torch.uint8).numpy().tobytes()


def _split(zs, rows, weights, blocks, int8=False):
    q = C // blocks
    total = None
    for i in range(blocks):
        part_rows = [r[i * q:(i + 1) * q] for r in rows]
        w = None if weights is None else weights[i * q:(i + 1) * q]
        s = sa.sign_sum_int8_group(zs, part_rows, w) if int8 \
            else sa.sign_sum_group(zs, part_rows, w)
        total = s if total is None else total + s
    return total


@pytest.mark.parametrize("blocks", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unweighted_split_equals_b1_bit_for_bit(blocks, dtype):
    zs, Ws, phis = _leaves(blocks, getattr(torch, dtype))
    want = ref.sign_agg_group_ref(zs, Ws, phis, None, PSI, ALPHA)
    s = _split(zs, Ws, None, blocks)
    assert s.dtype == torch.float32
    got = sa.sign_finish_group(zs, s, phis, PSI, ALPHA, C)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and _bits(a, b)
    assert torch.isnan(got[1][7]) and torch.isnan(want[1][7])


@pytest.mark.parametrize("blocks", [2, 4])
def test_unweighted_int8_split_equals_b3_bit_for_bit(blocks):
    zs, Ws, phis = _leaves(10 + blocks)
    pay = [collectives.encode_sign_message(z, W).payload
           for z, W in zip(zs, Ws)]
    want = ref.sign_agg_int8_group_ref(zs, pay, phis, None, PSI, ALPHA)
    s = _split(zs, pay, None, blocks, int8=True)
    assert s.dtype == torch.int32
    got = sa.sign_finish_group(zs, s, phis, PSI, ALPHA, C)
    for a, b in zip(got, want):
        assert _bits(a, b)


@pytest.mark.parametrize("blocks", [2, 4])
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_weighted_split_within_the_stated_bound(blocks, wire):
    zs, Ws, phis = _leaves(20 + blocks, ties=False)
    w = torch.rand(C, generator=torch.Generator().manual_seed(3)) + 0.05
    n = 40
    if wire == "int8":
        msgs = [collectives.encode_sign_message(z, W, w)
                for z, W in zip(zs, Ws)]
        rows = [m.payload for m in msgs]
        want = ref.sign_agg_int8_group_ref(zs, rows, phis, w, PSI, ALPHA,
                                           n_total=n)
    else:
        rows = Ws
        want = ref.sign_agg_group_ref(zs, Ws, phis, w, PSI, ALPHA,
                                      n_total=n)
    s = _split(zs, rows, w, blocks, int8=wire == "int8")
    got = sa.sign_finish_group(zs, s, phis, PSI, ALPHA, n)
    for z, p, a, b in zip(zs, phis, got, want):
        bound = ref.weighted_split_bound(z, p, w, n, PSI, ALPHA)
        assert bool(torch.all((a.double() - b.double()).abs()
                              <= bound.double()))


def test_partial_plain_versions_are_the_fused_folds_sums():
    """The partial over every row is the fused plain version's own sum:
    its epilogue applied gives the fused result bit for bit, weighted
    too (one block: the same fold)."""
    zs, Ws, phis = _leaves(7, ties=False)
    w = torch.rand(C, generator=torch.Generator().manual_seed(1))
    sums = ref.sign_sum_group_ref(zs, Ws, w)
    got = ref.sign_finish_group_ref(zs, sums, phis, PSI, ALPHA, 23)
    want = ref.sign_agg_group_ref(zs, Ws, phis, w, PSI, ALPHA, n_total=23)
    assert all(_bits(a, b) for a, b in zip(got, want))
    offs, total = sa.sum_offsets(SIZES)
    assert all(o % 4 == 0 for o in offs) and total >= sum(SIZES)


@pytest.mark.parametrize("message", ["f32", "int8"])
def test_ops_split_path_over_two_blocks_equals_fused(monkeypatch, message):
    """``sign_consensus_leaves(ranks=)`` with a 2-rank data axis: the
    partial of this rank's rows, the all-reduce (here: adding the other
    rank's partial), the finish; unweighted, the fused call's bits."""
    from repro_torch.distributed.data_parallel import Axis, RankBlock

    zs, Ws, phis = _leaves(31)
    other = sa.sign_sum_int8_group(
        zs, [collectives.encode_sign_message(z, W[8:]).payload
             for z, W in zip(zs, Ws)], None) if message == "int8" \
        else sa.sign_sum_group(zs, [W[8:] for W in Ws], None)

    def fake_all_reduce(t, axis):
        assert axis.name == "data" and axis.size == 2
        t += other
        return t

    monkeypatch.setattr(collectives, "all_reduce_sum", fake_all_reduce)
    ranks = RankBlock(Axis("data", None, 2, 0, 1),
                      Axis("model", None, 1, 0, 1), C)
    got = ops.sign_consensus_leaves(zs, [W[:8] for W in Ws], phis, None,
                                    PSI, ALPHA, message=message,
                                    ranks=ranks)
    want = ops.sign_consensus_leaves(zs, Ws, phis, None, PSI, ALPHA,
                                     message=message)
    assert all(_bits(a, b) for a, b in zip(got, want))


def test_meta_calls_count_the_work_and_launch_nothing():
    zs = [torch.empty(D, device="meta") for D in SIZES]
    Ws = [torch.empty(C, D, device="meta") for D in SIZES]
    pay = [torch.empty(C, D, dtype=torch.int8, device="meta")
           for D in SIZES]
    before = dict(sa.LAUNCHES)
    with CostCounter() as counter:
        s = sa.sign_sum_group(zs, Ws, None)
        s8 = sa.sign_sum_int8_group(zs, pay, None)
        out = sa.sign_finish_group(zs, s8, zs, PSI, ALPHA, C)
    assert sa.LAUNCHES == before
    assert s.device.type == "meta" and s8.dtype == torch.int32
    assert [o.shape[0] for o in out] == SIZES
    k = counter.kernels
    assert k["sign_sum"].launches == 2 and k["sign_finish"].launches == 1
    P = sum(SIZES)
    assert k["sign_sum"].nbytes == (C * P * 4 + P * 8) + (C * P + P * 4)
    assert k["sign_finish"].nbytes == P * 12 + P * 4


def test_finish_refuses_a_buffer_of_another_size():
    zs, _, phis = _leaves(0)
    with pytest.raises(ValueError, match="sums must be"):
        sa.sign_finish_group(zs, torch.zeros(3), phis, PSI, ALPHA, C)
    with pytest.raises(ValueError, match="divisor"):
        sa.sign_finish_group(zs, torch.zeros(sa.sum_offsets(SIZES)[1]),
                             phis, PSI, ALPHA, 0)
    np.testing.assert_array_equal(sa.sum_offsets([3, 4])[0], [0, 4])
