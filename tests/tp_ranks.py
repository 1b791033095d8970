"""Serving cases run tensor-parallel as every rank of a gloo group on the
CPU (``tests/test_torch_tensor_parallel.py``), through
``dp_ranks.run_ranks``, and at world 1 in the test's own process.

A case is a dict: ``arch`` (a smoke config, ``patch`` its fields
replaced), ``weights`` (the reference's ``init_lm`` tree as numpy),
``tokens`` (B, S) for a prefill (with a VLM's ``embeds``, its patch
prefix), ``prompts`` for ``ServeEngine`` (greedy,
``max_new`` tokens, ``cache_len``, a ring of ``window`` slots or 0).
:func:`run_case` runs it on a mesh (the rank's blocks, as
``sharding.local_tree(sharding.place_tree(...))`` gives them, through
``launch.steps.prefill_setup`` and ``ServeEngine(..., ranks=)``) or,
without one, at world 1, and returns numpy: the prefill's logits (the
rank's rows and vocabulary block), the embedding, the engine's tokens
and each step's logits, the exchanges counted per step, the attention
calls and the longest block B5's partial was given on this rank; on a
mesh also the exchanges predicted before the run, by the same steps
run first on ``meta`` structs of the rank's blocks from the setups
(``prefill_setup``/``decode_setup`` with ``rank_local``).  It imports
torch and the port, never JAX.
"""
from __future__ import annotations

import dataclasses

import torch

STEP_KEYS = ("flash_attention", "decode_attention",
             "decode_attention_partial")


def case_cfg(case):
    from repro_torch.configs import get_arch, reduce_for_smoke

    return dataclasses.replace(reduce_for_smoke(get_arch(case["arch"])),
                               **case.get("patch", {}))


class AttentionCalls:
    """Counts ``kernels.ops``' attention calls while entered (the plain
    versions run on the CPU; on the card each is one launch)."""

    def __enter__(self):
        from repro_torch.kernels import ops

        self.counts = dict.fromkeys(STEP_KEYS, 0)
        self.partial_len = 0        # the longest block a partial was given
        self._orig = {k: getattr(ops, k) for k in STEP_KEYS}

        def counted(name):
            def call(*a, **kw):
                self.counts[name] += 1
                if name == "decode_attention_partial":
                    self.partial_len = max(self.partial_len,
                                           int(a[3].max()))
                return self._orig[name](*a, **kw)
            return call

        for k in STEP_KEYS:
            setattr(ops, k, counted(k))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for k, f in self._orig.items():
            setattr(ops, k, f)


def _exchanged():
    from repro_torch.distributed import collectives

    return {k: dict(v) for k, v in collectives.COLLECTIVES.items()}


def _predicted(step, *args):
    """The exchanges ``step(*args)`` counts on meta structs (nothing is
    sent)."""
    from repro_torch.distributed import collectives

    collectives.reset_collective_counts()
    step(*args)
    return _exchanged()


def run_case(case, mesh=None):
    """``case`` at world 1 (``mesh`` None) or as this rank of ``mesh``."""
    from repro_torch.configs import InputShape
    from repro_torch.distributed import collectives
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import local_tree, place_tree
    from repro_torch.launch import steps
    from repro_torch.models import layers
    from repro_torch.models import transformer as tr
    from repro_torch.serving import ServeEngine, ServeRequest
    from repro_torch.tree import tree_leaves

    cfg = case_cfg(case)
    whole = tr.serving_tree(tr.lm_params_from_numpy(case["weights"], cfg,
                                                    device="cpu"))
    toks = torch.from_numpy(case["tokens"])
    B, S = toks.shape
    out = {}
    ranks = prows = None
    if mesh is None:
        params, step = whole, steps.make_prefill_step(cfg)
        rows = slice(None)
    else:
        prefix = case["embeds"].shape[1] if "embeds" in case else 0
        step, (p_sds, in_sds), (p_specs, _), _ = steps.prefill_setup(
            cfg, InputShape("case", S + prefix, B, "prefill"), mesh)
        params = local_tree(place_tree(whole, p_specs, mesh))
        out["structs_match"] = [tuple(a.shape) for a in
                                tree_leaves(p_sds)] == \
            [tuple(b.shape) for b in tree_leaves(params)]
        prows = tp.serve_block(mesh, B, p_specs)
        rows = prows.clients()
        out["prefill_predicted"] = _predicted(step, p_sds, in_sds)
        n_req = len(case["prompts"])
        d_step, d_args, _, _ = steps.decode_setup(
            cfg, InputShape("case", case["cache_len"], n_req, "decode"), mesh)
        out["step_predicted"] = _predicted(d_step, *d_args[:3], 0)
    inputs = {"tokens": toks[rows].contiguous()}
    if "embeds" in case:              # a VLM's patch prefix
        inputs["frontend_embeds"] = torch.from_numpy(
            case["embeds"])[rows].contiguous()
    collectives.reset_collective_counts()
    with AttentionCalls() as calls:
        logits = step(params, inputs)
    out["prefill"] = logits.numpy().copy()
    out["prefill_calls"] = calls.counts
    out["prefill_exchanged"] = _exchanged()
    out["embed"] = layers.embed(
        params["embed"], toks[rows], cfg,
        ranks=tp.at(prows, "embed")).numpy().copy()
    # the engine: greedy requests, token by token through B5
    n_req = len(case["prompts"])
    if mesh is not None:
        ranks = tp.serve_block(mesh, n_req, p_specs)
    eng = ServeEngine(params, cfg, batch=n_req, cache_len=case["cache_len"],
                      window=case.get("window", 0), device="cpu",
                      ranks=ranks)
    inner, seen = eng._step, []

    def spy(p, state, t, pos):
        collectives.reset_collective_counts()
        got, state = inner(p, state, t, pos)
        seen.append((got[:, -1].numpy().copy(), _exchanged()))
        return got, state

    eng._step = spy
    with AttentionCalls() as calls:
        toks_out = eng.generate([ServeRequest(prompt=p, max_new=case[
            "max_new"]) for p in case["prompts"]])
    out["tokens"] = [t.copy() for t in toks_out]
    out["step_logits"] = [s[0] for s in seen]
    out["step_exchanged"] = [s[1] for s in seen]
    out["engine_calls"] = calls.counts
    out["partial_len"] = calls.partial_len
    out["state_shapes"] = [tuple(t.shape) for t in
                           tree_leaves(eng.state)]
    out["rows"] = (0, B) if prows is None else (prows.c0, prows.c1)
    out["engine_rows"] = (0, n_req) if ranks is None else (ranks.c0,
                                                           ranks.c1)
    return out


# decode from a seeded cache of SEEDED_L positions, SEEDED_N steps from
# each first step: (name, window, first step).  Over 2 "model" ranks
# (64 positions a rank) "blocks" crosses into rank 1's block at step 64,
# "ring" wraps from rank 1's last slots to rank 0's first, "past_end"
# overwrites the full cache's last slot (rank 1's) past its end.
SEEDED = (("blocks", 0, 62), ("ring", 128, 126), ("past_end", 0, 127))
SEEDED_L, SEEDED_N = 128, 4


def seeded_decode(case, mesh=None):
    """``SEEDED``'s runs of ``make_decode_step`` for the case's weights
    from the seeded caches ``case["kv"]`` ((n_layers, B, L, Hkv, hd) K and
    V) and tokens ``case["seeded_tokens"]`` (B, SEEDED_N), at world 1 or
    as this rank (its blocks of the weights, its rows and positions of
    the caches, placed by ``steps.decode_state_specs``): per run, each
    step's last logits (the rank's vocabulary block) and the longest
    block B5's partial was given."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import (local_tree, map_leaves,
                                                  place_tree)
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr

    cfg = case_cfg(case)
    whole = tr.serving_tree(tr.lm_params_from_numpy(case["weights"], cfg,
                                                    device="cpu"))
    k, v = (torch.from_numpy(a) for a in case["kv"])
    toks = torch.from_numpy(case["seeded_tokens"])
    B = toks.shape[0]
    out = {}
    for name, window, s0 in SEEDED:
        state = {"layers": [{"k": k[i].clone(), "v": v[i].clone()}
                            for i in range(cfg.n_layers)]}
        ranks, params, rows = None, whole, slice(None)
        if mesh is not None:
            specs = steps.serving_specs(cfg, mesh)
            ranks = tp.serve_block(mesh, B, specs, steps.decode_state_specs(
                cfg, mesh, B, SEEDED_L, window))
            params = local_tree(place_tree(whole, specs, mesh))
            state = map_leaves(lambda t, sp: tp.block(t, sp, ranks).clone(),
                               state, ranks.state_specs)
            rows = ranks.clients()
        step = steps.make_decode_step(cfg, window, ranks)
        logits = []
        with AttentionCalls() as calls:
            for t in range(SEEDED_N):
                got, state = step(params, state,
                                  toks[rows, t:t + 1].contiguous(), s0 + t)
                logits.append(got[:, -1].numpy().copy())
        out[name] = dict(logits=logits, partial_len=calls.partial_len)
    return out


def tp_job(mesh, payload):
    """Every case of ``payload["cases"]`` and :func:`seeded_decode` of
    ``payload["seeded"]`` on this rank; with
    ``payload["init_seed"]``, also this rank's blocks drawn by
    ``transformer.init_lm`` with ``tensor_parallel.keep_blocks`` against
    ``init_lm``'s whole weights narrowed, and ``all_gather``'s counted
    bytes."""
    from repro_torch.distributed import collectives
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import local_tree, place_tree
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_leaves

    out = {name: run_case(case, mesh)
           for name, case in payload["cases"].items()}
    out["seeded"] = seeded_decode(payload["seeded"], mesh)
    if payload.get("init_seed") is not None:
        case = next(iter(payload["cases"].values()))
        cfg = case_cfg(case)
        specs = steps.serving_specs(cfg, mesh)
        ranks = tp.serve_block(mesh, 2, specs)
        mine = tr.init_lm(torch.Generator().manual_seed(
            payload["init_seed"]), cfg, keep=tp.keep_blocks(ranks, "cpu"))
        whole = tr.serving_tree(tr.init_lm(torch.Generator().manual_seed(
            payload["init_seed"]), cfg, device="cpu"))
        want = local_tree(place_tree(whole, specs, mesh))
        out["init_blocks_equal"] = all(
            torch.equal(a, b) and a.is_contiguous()
            for a, b in zip(tree_leaves(mine), tree_leaves(want)))
        collectives.reset_collective_counts()
        t = torch.arange(6, dtype=torch.float32).reshape(2, 3) \
            + 10 * ranks.model.rank
        got = collectives.all_gather(t, ranks.model, 1)
        out["all_gather"] = (got.numpy().copy(), _exchanged())
    return out
