"""The federated train loop (the port of ``FederatedRun`` from the JAX
package's ``core/schedule.py``).  Event-driven ``Schedule``s, their
policies and the privacy ledger's per-delivery feed are not ported yet;
the round's activity comes from its internal sampler or from a
``round_kwargs`` hook (explicit ``act=``/``stale=`` rows)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import resolve_device


def round_generator(seed: int, t: int, device) -> torch.Generator:
    """The round-``t`` generator of a run seeded ``seed`` (the counterpart
    of the reference's ``jax.random.fold_in(key, t)``): a seed mixed from
    ``(seed, t)`` by numpy's ``SeedSequence``."""
    mixed = int(np.random.SeedSequence([seed, t]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(mixed)


@dataclasses.dataclass
class FederatedRun:
    """Drives ``step(state, batch, gen, **kw)`` for ``rounds`` rounds.

    * ``schedule`` must be ``None`` (the internal sampler): event-driven
      schedules are not ported yet and raise.
    * ``round_kwargs``: a ``t -> dict`` hook of per-round kwargs (the
      explicit ``act=``/``stale=`` rows).
    * ``start``: checkpoint-resume — rounds before it are skipped.
    * ``key_fn``: ``t -> torch.Generator``; default
      :func:`round_generator` on ``device`` from the ``seed`` given to
      :meth:`run`.
    * ``device``: where the default generators live (``None`` = the GPU).
    """
    step: Callable[..., Tuple[Any, Dict[str, Any]]]
    rounds: int
    schedule: Optional[Any] = None
    start: int = 0
    key_fn: Optional[Callable[[int], torch.Generator]] = None
    round_kwargs: Optional[Callable[[int], Dict[str, Any]]] = None
    device: Optional[Any] = None

    def run(self, state, batch_fn: Callable[[int], Any],
            seed: Optional[int] = None, *, collect: Tuple[str, ...] = (),
            derive: Optional[Dict[str, Callable[[Any, Dict], Any]]] = None,
            skip_missing: bool = False,
            on_round: Optional[Callable[[int, Any, Dict], None]] = None):
        """Returns ``(final_state, history)``, ``history[k]`` one entry per
        trained round for every ``k`` in ``collect`` (``derive[k](state,
        m)`` when given, else ``float(m[k])``; NaN for a missing key under
        ``skip_missing``)."""
        if self.schedule is not None:
            raise ValueError(
                "FederatedRun(schedule=...) is not yet ported to repro_torch"
                " (see ROADMAP.md, Queue A); pass schedule=None or "
                "round_kwargs=")
        if self.key_fn is None and seed is None:
            raise ValueError("need a base seed (or a key_fn)")
        key_fn = self.key_fn
        if key_fn is None:
            dev = resolve_device(self.device)

            def key_fn(t):
                return round_generator(seed, t, dev)

        derive = derive or {}
        hist: Dict[str, List[Any]] = {k: [] for k in collect}
        for t in range(self.start, self.rounds):
            kwargs = {} if self.round_kwargs is None else self.round_kwargs(t)
            state, m = self.step(state, batch_fn(t), key_fn(t), **kwargs)
            if on_round is not None:
                on_round(t, state, m)
            for k in collect:
                if k in derive:
                    hist[k].append(derive[k](state, m))
                elif k in m:
                    hist[k].append(float(m[k]))
                elif skip_missing:
                    hist[k].append(float("nan"))
                else:
                    raise KeyError(
                        f"collect key {k!r} not in metrics {sorted(m)}")
        return state, hist
