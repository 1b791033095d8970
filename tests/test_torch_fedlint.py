"""fedlint over the aten op log (``repro_torch/analysis/``) on the CPU.

* Every fixture pair runs in the port, all five (the reference's f64 pair
  cannot run on this jax: ROADMAP reference behaviour 5): the broken twin
  trips its rule, the clean twin passes; on the four pairs the reference
  can run, its verdicts equal the port's.
* The manifest has the reference's eight entry names and each passes
  after ``baseline.json``; fingerprints are stable across two runs, and a
  stale baseline entry is reported.
* ``contract`` on ``bafdp_round_sparse`` is off by default (no tracing at
  all) and under ``REPRO_FEDLINT=1`` raises ``ContractViolation`` on a
  round seeded with a dense (C, D) intermediate, while the clean round
  passes the check and runs as without it.
"""
import importlib
import json

import numpy as np
import pytest
import torch
from test_torch_reference import reference  # noqa: F401

from repro_torch.analysis import (ContractViolation, HostSyncRule, cli,
                                  fixtures, lint_jaxpr, trace, verify)
from repro_torch.analysis.manifest import build_manifest

NAMES = [fx.name for fx in fixtures.FIXTURES]


def verdicts(fx, lint):
    """(broken caught, clean passes) of one fixture under ``lint``."""
    broken = lint(fx.trace_broken(), [fx.make_rule()], fx.bindings)
    clean = lint(fx.trace_clean(), [fx.make_rule()], fx.bindings)
    return (any(f.rule == fx.rule_id for f in broken.findings),
            not any(f.rule == fx.rule_id and f.severity == "error"
                    for f in clean.findings))


@pytest.mark.parametrize("name", NAMES)
def test_every_fixture_pair_is_caught_and_passed(name):
    fx = next(f for f in fixtures.FIXTURES if f.name == name)
    assert verdicts(fx, lint_jaxpr) == (True, True)
    assert fixtures.run_selftest() == [] if name == NAMES[-1] else True


# The reference's rng-discipline rule misses its own seeded violation on
# this jax (ROADMAP reference behaviour 13): ``jax.random.normal`` is a
# ``jit`` equation, which its CALL_PRIMS (``pjit``, ...) does not list, so
# the key entering it is a fresh value each time.
REFERENCE_MISSES = {"key-reusing-corrupt": (False, True)}


@pytest.mark.parametrize("name", [n for n in NAMES if "f64" not in n])
def test_the_reference_gives_the_same_verdicts(reference, name):
    ref_fx = importlib.import_module("repro.analysis.fixtures")
    ref_verify = importlib.import_module("repro.analysis.verify")
    ref = next(f for f in ref_fx.FIXTURES if f.name == name)
    port = next(f for f in fixtures.FIXTURES if f.name == name)
    assert ref.rule_id == port.rule_id
    assert verdicts(port, lint_jaxpr) == (True, True)
    assert verdicts(ref, ref_verify.lint_jaxpr) == REFERENCE_MISSES.get(
        name, (True, True))


def test_a_host_read_is_a_sync_only_of_a_device_value():
    """``.item()`` of a CPU tensor is no sync; of a meta tensor (the card's
    stand-in) it is, and the trace stops there."""
    def read(z):
        return float(z.sum())

    cpu = lint_jaxpr(trace(read, torch.ones(3)), [HostSyncRule()])
    assert cpu.ok and cpu.n_eqns == 2
    meta = verify(read, torch.empty(3, device="meta"), rules=[HostSyncRule()])
    assert meta.aborted and not meta.ok
    assert [f.primitive for f in meta.errors] == ["_local_scalar_dense"]


def test_manifest_has_the_reference_names_and_passes_after_baseline(
        reference, capsys, tmp_path):
    ref_manifest = importlib.import_module("repro.analysis.manifest")
    assert [e.name for e in build_manifest("cpu")] == \
        [e.name for e in ref_manifest.build_manifest()]
    if not torch.cuda.is_available():   # the card unless asked for the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([])
    out = tmp_path / "report.json"
    assert cli.main(["--device", "cpu", "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["ok"] and all(e["ok"] for e in report["entries"])
    baseline = cli.load_baseline(cli.DEFAULT_BASELINE)
    assert baseline and all(len(why) > 200 for why in baseline.values())
    # the one host read fires on the card only: stale here, reported
    card_only = [fp for fp, why in baseline.items()
                 if why.startswith("The card only")]
    assert report["stale_baseline"] == card_only and len(card_only) == 1
    suppressed = {s["fingerprint"] for e in report["entries"]
                  for s in e["suppressed"]}
    assert suppressed == set(baseline) - set(card_only)
    assert "-- fedlint: 8 entrypoint(s), 0 error(s)" in \
        capsys.readouterr().out


def test_fingerprints_are_stable_and_a_stale_entry_is_reported(tmp_path,
                                                               capsys):
    entries = [e for e in build_manifest("cpu")
               if e.name == "dense-round-active"]
    runs = [{f.fingerprint for f in lint_jaxpr(
        e.trace(), e.make_rules(), e.bindings).findings}
        for e in entries * 2]
    assert runs[0] == runs[1] and len(runs[0]) == 9
    stale = "host-sync|_to_copy|<top>|shape=(1,) dtype=float32"
    path = tmp_path / "baseline.json"
    path.write_text(json.dumps({"suppressions": {
        **cli.load_baseline(cli.DEFAULT_BASELINE), stale: "not any more"}}))
    assert cli.main(["--device", "cpu", "--only", "dense-round",
                     "--baseline", str(path)]) == 0
    assert f"WARNING: stale baseline entry (fires nowhere): {stale}" in \
        capsys.readouterr().out
    assert cli.main(["--device", "cpu", "--only", "dense-round-active",
                     "--baseline",
                     str(tmp_path / "none.json")]) == 1
    assert cli.main(["--selftest"]) == 0
    assert cli.main(["--device", "cpu", "--list"]) == 0
    assert cli.main(["--device", "cpu", "--only", "no-such-entry"]) == 1


def _sparse_problem(C=48, S=6, D=5):
    from repro_torch.configs import FedConfig
    from repro_torch.core.byzantine import byz_mask
    from repro_torch.core.fed_state import init_fed_state

    fed = FedConfig(n_clients=C, active_frac=S / C, consensus_scope="active",
                    omega_optimizer="sgd")
    g = torch.Generator().manual_seed(0)
    state = init_fed_state(g, lambda k: {"w": torch.randn((D,), generator=k)},
                           fed, n_clients=C, device="cpu")
    X = torch.randn((S, 3, D), generator=g)
    Y = X[..., 0]

    def local_loss(W, batch, gen, eps):
        x, y = batch
        return torch.mean((torch.einsum("sbd,sd->sb", x, W["w"]) - y) ** 2,
                          dim=1)

    kw = dict(local_loss=local_loss, fed=fed, c3=1.0, n_samples=50, d_dim=D,
              byz_mask=byz_mask(C, 0), idx=np.arange(S) * 7,
              stale=np.zeros(S, np.float32), weight=np.ones(S, np.float32))
    return state, (X, Y), kw


def test_contract_is_off_by_default_and_catches_a_densifying_round(
        monkeypatch):
    from repro_torch.core import bafdp
    from repro_torch.tree import tree_leaves, tree_map

    monkeypatch.delenv("REPRO_FEDLINT", raising=False)

    def no_trace(*a, **k):
        raise AssertionError("the contract traced while off")

    monkeypatch.setattr(importlib.import_module(
        "repro_torch.analysis.verify"), "verify", no_trace)
    state, batch, kw = _sparse_problem()
    want, _ = bafdp.bafdp_round_sparse(bafdp._clone_state(state), batch,
                                       torch.Generator().manual_seed(3),
                                       **kw)
    monkeypatch.undo()

    def densifying_gather(tree, idx):
        # every client's rows through a (C, D) product, then the S rows
        return tree_map(lambda l: (l * 1.0).index_select(
            0, torch.clamp(idx.to(torch.long), 0, l.shape[0] - 1)), tree)

    monkeypatch.setenv("REPRO_FEDLINT", "1")
    with monkeypatch.context() as m:
        m.setattr(bafdp, "gather_clients", densifying_gather)
        with pytest.raises(ContractViolation, match="memory-contract"):
            bafdp.bafdp_round_sparse(bafdp._clone_state(state), batch,
                                     torch.Generator().manual_seed(3), **kw)
    got, _ = bafdp.bafdp_round_sparse(bafdp._clone_state(state), batch,
                                      torch.Generator().manual_seed(3), **kw)
    for a, b in zip(tree_leaves(got.W), tree_leaves(want.W)):
        assert torch.equal(a, b)
    report = bafdp.bafdp_round_sparse.fedlint(state, batch,
                                              torch.Generator(), **kw)
    assert report.ok and report.n_eqns > 100
