"""Batched serving engine: batched decode over a shared KV cache, greedy
or temperature sampling, per-request lengths (the port of the JAX
package's ``serving/engine.py``).

As in the reference, the prompts are left-padded with token 0 (the pad
positions are attended) and fed token by token through the decode step,
so prefill and generation run one program: B5 in every attention layer
of every step, and no B6 (a Mamba layer's decode is a one-step update).
An MoE FFN routes the batch's B tokens of a step (capacity per call, at
least 8 slots an expert), with no kernel of its own.  An mLSTM or sLSTM
layer (xLSTM) takes one step of its recurrence, launching no kernel.
The decode state (``tr.init_decode_state``) holds each layer's K/V caches
and, for Mamba and Hymba layers, the scan state ``h`` and the convolution
window ``conv``, for xLSTM layers their recurrent states; the step writes
all of them in place.  An encoder-decoder's state also holds the
encoder's ``memory``, which every decoder layer's cross-attention reads
(B5 over all of it); like the reference's, the engine never fills it:
it stays at the zeros of ``init_decode_state`` unless the caller sets
``engine.state["memory"] = tr.encode(...)`` before ``generate``.  A
VLM's frontend takes no part in decoding.  Random draws come from a
``torch.Generator`` on the engine's device, seeded from ``seed``; they
are not ``jax.random``'s numbers.

``ranks=`` (``tensor_parallel.serve_block``: a rank of a ("data",
"model") mesh, with the plan's per-layer parameter specs): ``params`` is
the rank's blocks in ``transformer.serving_tree``'s layout
(``transformer.init_lm(..., keep=tensor_parallel.keep_blocks(...))``),
the engine makes its block of the
decode state placed by ``launch.steps.decode_state_specs`` (its B/R rows
on ``"data"``; on ``"model"`` its positions of each K/V cache and its
channels of a Mamba layer's ``h`` and ``conv``; an encoder-decoder's
``memory`` its rows, whole in d: set it from the rank's own
``tr.encode(params, enc_embeds[engine.rows], cfg, ranks=engine.ranks)``)
and steps tensor-parallel.
Every rank is handed every request; a rank serves its rows.  The
logits' vocabulary blocks are gathered before sampling and every rank
draws the whole batch's uniforms from its identically seeded generator,
keeping its rows (so a rank draws what world 1 draws for them); the
tokens are gathered over ``"data"`` at the end, so ``generate`` returns
every request's on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch.steps import decode_state_specs, make_decode_step
from repro_torch.models import transformer as tr
from repro_torch.models.layers import dtype_of
from repro_torch.tree import resolve_device, tree_leaves


@dataclasses.dataclass
class ServeRequest:
    prompt: np.ndarray          # (P,) int32
    max_new: int = 16
    temperature: float = 0.0
    rid: int = 0


def make_serve_step(cfg: ArchConfig, window: int = 0, ranks=None):
    """serve_step(params, state, tokens (B,1), step) -> (logits, state)."""
    return make_decode_step(cfg, window, ranks)


def _named_tensors(params):
    if isinstance(params, torch.nn.Module):
        return list(params.named_parameters())
    return [(str(i), t) for i, t in enumerate(tree_leaves(params))]


class ServeEngine:
    def __init__(self, params, cfg: ArchConfig, batch: int, cache_len: int,
                 window: int = 0, seed: int = 0, device=None, ranks=None):
        self.device = resolve_device(device)
        for name, t in _named_tensors(params):
            if t.device.type != self.device.type:
                raise ValueError(f"parameter {name} is on {t.device}, the "
                                 f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.batch = batch
        self.window = window
        self.cache_len = cache_len
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        cdt = dtype_of(cfg.compute_dtype)
        self.ranks = None
        self.rows = slice(None)
        if ranks is not None and ranks.world > 1:
            if ranks.n_clients != batch:
                raise ValueError(f"the rank block splits {ranks.n_clients} "
                                 f"rows, the engine serves {batch}")
            mesh = MeshShape(("data", "model"),
                             (ranks.data.size, ranks.model.size))
            s_specs = decode_state_specs(cfg, mesh, batch, cache_len,
                                         window)
            self.ranks = dataclasses.replace(ranks, state_specs=s_specs)
            self.rows = ranks.clients()
            whole = tr.init_decode_state(cfg, batch, cache_len, cdt,
                                         window=window, device="meta")
            self.state = tp.local_zeros(whole, s_specs, self.ranks,
                                        self.device)
        else:
            self.state = tr.init_decode_state(cfg, batch, cache_len, cdt,
                                              window=window,
                                              device=self.device)
        self._step = make_serve_step(cfg, window, self.ranks)
        self.steps = 0           # decode steps run, prefill included

    def prefill(self, prompts: List[np.ndarray]) -> torch.Tensor:
        """Token-by-token prefill through the decode path; returns the last
        step's logits (B, 1, vocab_pad)."""
        if not 0 < len(prompts) <= self.batch:
            raise ValueError(f"{len(prompts)} prompts for a batch of "
                             f"{self.batch}")
        maxlen = max(len(p) for p in prompts)
        toks = np.zeros((self.batch, maxlen), np.int64)
        for i, p in enumerate(prompts):
            toks[i, maxlen - len(p):] = p       # left-pad
        toks = torch.from_numpy(toks[self.rows]).to(self.device)
        for t in range(maxlen):
            logits, self.state = self._step(self.params, self.state,
                                            toks[:, t:t + 1], t)
        self.steps += maxlen
        self.pos = maxlen
        return logits

    def generate(self, requests: List[ServeRequest]) -> List[np.ndarray]:
        logits = self.prefill([r.prompt for r in requests])
        max_new = max(r.max_new for r in requests)
        cur = self._sample(logits, requests)
        drawn = []
        for step in range(max_new):
            drawn.append(cur[:, 0])
            logits, self.state = self._step(self.params, self.state, cur,
                                            self.pos + step)
            cur = self._sample(logits, requests)
        self.steps += max_new
        toks = torch.stack(drawn, dim=1)
        if self.ranks is not None:
            toks = collectives.all_gather(toks.contiguous(), self.ranks.data,
                                          0)
        toks = toks.cpu().numpy().astype(np.int32)
        return [toks[i, :r.max_new] for i, r in enumerate(requests)]

    def _sample(self, logits: torch.Tensor, requests) -> torch.Tensor:
        """Greedy rows take the argmax; the others a Gumbel-max draw at
        temperature ``max(T, 1e-6)``.  Rows past the requests are greedy."""
        if tp.active(self.ranks):
            logits = tp.gather(logits, self.ranks, -1)
        logits = logits[:, -1, :self.cfg.vocab_size]
        greedy = logits.argmax(dim=-1)
        pad = self.batch - len(requests)
        temps = torch.tensor([max(r.temperature, 1e-6) for r in requests]
                             + [1e-6] * pad, dtype=logits.dtype,
                             device=self.device)[self.rows]
        u = torch.rand((self.batch, logits.shape[-1]), generator=self.gen,
                       device=self.device)[self.rows]
        gumbel = -torch.log(-torch.log(u))
        sampled = (logits / temps[:, None] + gumbel).argmax(dim=-1)
        use_greedy = torch.tensor([r.temperature == 0.0 for r in requests]
                                  + [True] * pad, device=self.device)
        return torch.where(use_greedy[self.rows], greedy, sampled)[:, None]
