"""Serving cases run tensor-parallel as every rank of a gloo group on the
CPU (``tests/test_torch_tensor_parallel.py``), through
``dp_ranks.run_ranks``, and at world 1 in the test's own process.

A case is a dict: ``arch`` (a smoke config, ``patch`` its fields
replaced), ``weights`` (the reference's ``init_lm`` tree as numpy),
``tokens`` (B, S) for a prefill (with a VLM's ``embeds``, its patch
prefix, or an encoder-decoder's ``enc``, the encoder's frames for the
prefill and the engine's memory), ``prompts`` for ``ServeEngine``
(greedy, ``max_new`` tokens, ``cache_len``, a ring of ``window`` slots
or 0).
:func:`run_case` runs it on a mesh (the rank's blocks, as
``sharding.local_tree(sharding.place_tree(...))`` gives them, through
``launch.steps.prefill_setup`` and ``ServeEngine(..., ranks=)``) or,
without one, at world 1, and returns numpy: the prefill's logits (the
rank's rows and vocabulary block), the embedding, the engine's tokens
and each step's logits, the exchanges counted per step, the attention
calls (and B6's, for a config with Mamba layers), the longest block B5's
partial was given on this rank, the shapes of the rank's weights and
decode state and, for an MoE config, every routing the rank made (its
tokens' experts, positions and kept slots: :class:`Routes`); on a
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
    """Counts ``kernels.ops``' attention calls (and those of ``keys``)
    while entered (the plain versions run on the CPU; on the card each
    is one launch)."""

    def __init__(self, keys=STEP_KEYS):
        self.keys = keys

    def __enter__(self):
        from repro_torch.kernels import ops

        self.counts = dict.fromkeys(self.keys, 0)
        self.partial_len = 0        # the longest block a partial was given
        self._orig = {k: getattr(ops, k) for k in self.keys}

        def counted(name):
            def call(*a, **kw):
                self.counts[name] += 1
                if name == "decode_attention_partial":
                    self.partial_len = max(self.partial_len,
                                           int(a[3].max()))
                return self._orig[name](*a, **kw)
            return call

        for k in self.keys:
            setattr(ops, k, counted(k))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops

        for k, f in self._orig.items():
            setattr(ops, k, f)


class Routes:
    """Records ``models.moe.route``'s routings while entered, as numpy
    (idx, pos, keep) per call."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.real, self.calls = moe, moe.route, []

        def spy(*a, **kw):
            r = self.real(*a, **kw)
            self.calls.append(tuple(t.numpy().copy()
                                    for t in (r.idx, r.pos, r.keep)))
            return r

        moe.route = spy
        return self

    def __exit__(self, *exc):
        self.moe.route = self.real


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


def kernel_keys(cfg):
    """The ``kernels.ops`` calls a case counts: attention's, and B6's
    where the config has Mamba layers."""
    from repro_torch.configs.base import HYMBA, MAMBA

    if set(cfg.pattern()) & {HYMBA, MAMBA}:
        return STEP_KEYS + ("ssm_scan",)
    return STEP_KEYS


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
    from repro_torch.tree import tree_leaves, tree_map

    cfg = case_cfg(case)
    keys = kernel_keys(cfg)
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
    if "enc" in case:                 # an encoder-decoder's frames
        inputs["enc_embeds"] = torch.from_numpy(case["enc"])[rows].contiguous()
    collectives.reset_collective_counts()
    with AttentionCalls(keys) as calls, Routes() as routes:
        logits = step(params, inputs)
    out["prefill"] = logits.numpy().copy()
    out["prefill_routes"] = routes.calls
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
    if "enc" in case:       # the rank's rows of the memory, its own encode
        collectives.reset_collective_counts()
        eng.state["memory"] = tr.encode(
            params, torch.from_numpy(case["enc"])[eng.rows].contiguous(),
            cfg, ranks=eng.ranks)
        out["encode_exchanged"] = _exchanged()
    inner, seen = eng._step, []

    def spy(p, state, t, pos):
        collectives.reset_collective_counts()
        got, state = inner(p, state, t, pos)
        seen.append((got[:, -1].numpy().copy(), _exchanged()))
        return got, state

    eng._step = spy
    with AttentionCalls(keys) as calls, Routes() as routes:
        toks_out = eng.generate([ServeRequest(prompt=p, max_new=case[
            "max_new"]) for p in case["prompts"]])
    out["engine_routes"] = routes.calls
    out["tokens"] = [t.copy() for t in toks_out]
    out["step_logits"] = [s[0] for s in seen]
    out["step_exchanged"] = [s[1] for s in seen]
    out["engine_calls"] = calls.counts
    out["partial_len"] = calls.partial_len
    out["state_shapes"] = [tuple(t.shape) for t in
                           tree_leaves(eng.state)]
    out["state_tree"] = tree_map(lambda t: tuple(t.shape), eng.state)
    out["param_tree"] = tree_map(lambda t: tuple(t.shape), params)
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


def recurrent_decode(case, mesh=None):
    """``SEEDED_N`` steps of ``make_decode_step`` for the case's weights
    from the whole decode state ``case["state"]`` (every leaf of
    ``init_decode_state``'s list drawn by the test: a recurrent state
    that is not symmetric, trap X) and tokens ``case["seeded_tokens"]``
    (B, SEEDED_N), at world 1 or as this rank (its blocks of the weights,
    its rows and blocks of the state, placed by
    ``steps.decode_state_specs``): each step's last logits (the rank's
    vocabulary block) and the state's leaves after them (the rank's
    blocks)."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import (local_tree, map_leaves,
                                                  place_tree)
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tr
    from repro_torch.tree import tree_map

    cfg = case_cfg(case)
    whole = tr.serving_tree(tr.lm_params_from_numpy(case["weights"], cfg,
                                                    device="cpu"))
    state = tree_map(lambda a: torch.from_numpy(a).clone(), case["state"])
    toks = torch.from_numpy(case["seeded_tokens"])
    B = toks.shape[0]
    ranks, params, rows = None, whole, slice(None)
    if mesh is not None:
        specs = steps.serving_specs(cfg, mesh)
        ranks = tp.serve_block(mesh, B, specs, steps.decode_state_specs(
            cfg, mesh, B, case["cache_len"]))
        params = local_tree(place_tree(whole, specs, mesh))
        state = map_leaves(lambda t, sp: tp.block(t, sp, ranks).clone(),
                           state, ranks.state_specs)
        rows = ranks.clients()
    step = steps.make_decode_step(cfg, 0, ranks)
    logits = []
    for t in range(SEEDED_N):
        got, state = step(params, state, toks[rows, t:t + 1].contiguous(), t)
        logits.append(got[:, -1].numpy().copy())
    return dict(logits=logits,
                state=tree_map(lambda t: t.numpy().copy(), state))


# a Mamba mixer's leaves placed off their channel dims: x_proj and
# out_proj on their outputs, dt_proj on its input, A_log on its states,
# conv_w, conv_b and dt_bias replicated (each gathered at use, or its
# product taken as its spec says); in_proj and D as the plan places them
OFF_CHANNELS = dict(in_proj=(None, "model"), conv_w=(None, None),
                    conv_b=(None,), x_proj=(None, "model"),
                    dt_proj=("model", None), dt_bias=(None,),
                    A_log=(None, "model"), D=("model",),
                    out_proj=(None, "model"))
MIXER_B, MIXER_S = 2, 20


def mixer_inputs(seed):
    """Hymba's smoke config, one Mamba mixer's whole weights from ``seed``,
    a prefill's input (MIXER_B, MIXER_S, d), a decode step's input and
    its state ``h``/``conv`` (f32 normals)."""
    from repro_torch.configs import get_arch, reduce_for_smoke
    from repro_torch.models import ssm

    cfg = reduce_for_smoke(get_arch("hymba-1.5b"))
    g = torch.Generator().manual_seed(seed)
    params = ssm.init_mamba(g, cfg, d_in=cfg.d_model)
    params["conv_b"] = torch.randn(cfg.d_model, generator=g) * 0.1
    d = cfg.d_model
    x = torch.randn((MIXER_B, MIXER_S, d), generator=g)
    x1 = torch.randn((MIXER_B, 1, d), generator=g)
    state = {"h": torch.randn((MIXER_B, d, cfg.ssm_state), generator=g),
             "conv": torch.randn((MIXER_B, ssm.CONV_WIDTH - 1, d),
                                 generator=g)}
    return cfg, params, x, x1, state


def mixer_off_channels(mesh, seed):
    """:func:`mixer_inputs` through ``ssm.mamba_scan`` and one
    ``mamba_decode`` step on this rank, its leaves placed as
    OFF_CHANNELS (its blocks of them), the state its channels: the
    outputs (whole) and the state's blocks after the step."""
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.sharding import P
    from repro_torch.models import ssm

    cfg, whole, x, x1, state = mixer_inputs(seed)
    specs = {k: P(*v) for k, v in OFF_CHANNELS.items()}
    state_specs = {"h": P(None, "model", None), "conv": P(None, None,
                                                          "model")}
    ranks = tp.serve_block(mesh, MIXER_B, specs, state_specs)
    params = {k: tp.block(w, specs[k], ranks).clone()
              for k, w in whole.items()}
    mine = {k: tp.block(t, state_specs[k], ranks).clone()
            for k, t in state.items()}
    out = ssm.mamba_scan(params, x, cfg, ranks=ranks)
    step, mine = ssm.mamba_decode(params, x1, mine, cfg, ranks=ranks)
    return dict(prefill=out.numpy().copy(), step=step.numpy().copy(),
                state={k: t.numpy().copy() for k, t in mine.items()})


def tp_job(mesh, payload):
    """Every case of ``payload["cases"]``, :func:`seeded_decode` of
    ``payload["seeded"]``, :func:`recurrent_decode` of
    ``payload["recurrent"]`` and :func:`mixer_off_channels` of
    ``payload["mixer"]`` (where given) on this rank; with
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
    if "seeded" in payload:
        out["seeded"] = seeded_decode(payload["seeded"], mesh)
    if "recurrent" in payload:
        out["recurrent"] = recurrent_decode(payload["recurrent"], mesh)
    if "mixer" in payload:
        out["mixer"] = mixer_off_channels(mesh, payload["mixer"])
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
