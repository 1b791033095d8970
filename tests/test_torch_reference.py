"""Shared helpers for the port's parity tests, and tests of the helpers.

The JAX package does not import on the installed jax (its
``analysis/traversal.py`` imports ``ClosedJaxpr``/``Jaxpr`` from
``jax.core``, which now keeps them in ``jax.extend.core``).
:func:`load_reference` installs that alias and imports the reference; the
port's tests call it from fixtures only, never at import or collection
time, and the ``reference`` fixture takes the alias and the modules it
let in away again on teardown, so the reference's own test files are
collected and run exactly as without it, whatever runs before them.
"""
import contextlib
import importlib
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro_torch.core.fed_state import FedState
from repro_torch.tree import tree_map

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def install_jax_core_alias() -> list:
    """Alias ``jax.core.ClosedJaxpr``/``Jaxpr`` from ``jax.extend.core``;
    returns the names it added."""
    import jax.core
    import jax.extend.core as jex_core

    added = [n for n in ("ClosedJaxpr", "Jaxpr") if not hasattr(jax.core, n)]
    for name in added:
        setattr(jax.core, name, getattr(jex_core, name))
    return added


def load_reference() -> SimpleNamespace:
    """Install the ``jax.core`` alias, then import the reference modules
    the port is held to (``benchmarks.common`` too: it imports
    ``repro.core``)."""
    install_jax_core_alias()
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)
    names = {
        "configs": "repro.configs", "bafdp": "repro.core.bafdp",
        "aggregators": "repro.core.aggregators",
        "trainers": "repro.core.trainers",
        "byzantine": "repro.core.byzantine", "dro": "repro.core.dro",
        "fed_state": "repro.core.fed_state",
        "privacy": "repro.core.privacy", "schedule": "repro.core.schedule",
        "collectives": "repro.distributed.collectives",
        "data": "repro.data", "windowing": "repro.data.windowing",
        "ops": "repro.kernels.ops", "ref": "repro.kernels.ref",
        "sign_agg": "repro.kernels.sign_agg",
        "forecasting": "repro.models.forecasting",
        "layers": "repro.models.layers", "common": "benchmarks.common",
    }
    return SimpleNamespace(**{k: importlib.import_module(v)
                              for k, v in names.items()})


@contextlib.contextmanager
def loaded_reference():
    """:func:`load_reference` for the duration of a ``with`` block; on exit
    the alias goes and so do the ``repro``/``benchmarks`` modules imported
    through it."""
    import jax.core

    before = set(sys.modules)
    added = install_jax_core_alias()
    try:
        yield load_reference()
    finally:
        for name in set(sys.modules) - before:
            if name.split(".")[0] in ("repro", "benchmarks"):
                del sys.modules[name]
        for name in added:
            delattr(jax.core, name)


@contextlib.contextmanager
def one_thread():
    """Run torch on one intra-op thread for the block.  A federated round
    on the CPU is thousands of small ops, which run fastest on one thread,
    and the test workers then do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@contextlib.contextmanager
def fake_mesh(shape, names, rank=0):
    """A ``DeviceMesh`` of ``shape`` over torch's ``fake`` process-group
    backend (no peers, no communication) as rank ``rank`` of
    ``prod(shape)``, for the block; the group is destroyed after it.  One
    process holds one group: use one such block at a time."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    with loaded_reference() as ref:
        yield ref


def test_loaded_reference_restores_the_broken_import():
    """Inside the block ``repro.core`` imports; after it, it fails again as
    without the alias (a fresh interpreter: this one may hold a fixture)."""
    import subprocess

    code = (
        "import sys; sys.path[:0] = ['src', 'tests']\n"
        "from test_torch_reference import loaded_reference\n"
        "with loaded_reference() as r:\n"
        "    assert r.bafdp.__name__ == 'repro.core.bafdp'\n"
        "try:\n"
        "    import repro.core\n"
        "except ImportError as e:\n"
        "    print('ImportError', 'ClosedJaxpr' in str(e))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "ImportError True"


def ref_state_arrays(ref_state) -> dict:
    """The reference ``FedState`` as a dict of numpy trees."""
    return {k: jax.tree.map(np.asarray, v)
            for k, v in ref_state._asdict().items()}


def port_state_arrays(state: FedState) -> dict:
    """The port's ``FedState`` as a dict of numpy trees (copies: the
    sparse round writes into the state it is given)."""
    return {k: None if v is None else tree_map(
        lambda t: t.detach().cpu().numpy().copy(), v)
        for k, v in state._asdict().items()}


def flat_items(tree, prefix=""):
    """``(path, leaf)`` pairs of a nested dict in sorted-key order (a
    tuple's or list's entries by position, as an LM's ``unit``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_items(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from flat_items(t, f"{prefix}/{i}")
    elif tree is not None:
        yield prefix, tree


def assert_states_close(got: dict, want: dict, *, rtol: float, atol: float,
                        exact=("t", "tau", "opt/count")) -> None:
    """Every leaf of two state dicts (numpy trees) agrees: integer
    counters exactly, floats within (rtol, atol)."""
    g = dict(flat_items(got))
    w = dict(flat_items(want))
    assert sorted(g) == sorted(w)
    for path in g:
        a, b = np.asarray(g[path]), np.asarray(w[path])
        assert a.shape == b.shape, path
        if path.lstrip("/") in exact:
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=path)


class StandInTraining:
    """A stand-in for either package's ``train_bafdp`` and
    ``eval_rmse_mae``, so that a paper script's layout and arithmetic run
    without training.  Call ``k`` of an instance draws its numbers from
    ``RandomState(k)``: two instances handed to the two packages' scripts,
    which train in the same order, give both the same histories.

    The histories hold every metric the scripts collect: ``data_loss``,
    ``consensus_gap`` (a decaying series), ``eps_all`` (one (C,) array a
    round) and ``n_active`` (the schedule's mask row sums, or every
    client without a schedule).  The state's ``z`` and the config are
    ``None``; ``feds`` records each call's ``FedConfig``."""

    def __init__(self):
        self.calls = 0
        self.evals = 0
        self.feds = []

    def train_bafdp(self, dataset, horizon, fed, rounds=150, *args,
                    schedule=None, **kwargs):
        rng = np.random.RandomState(self.calls)
        self.calls += 1
        self.feds.append(fed)
        decay = np.exp(-np.arange(rounds) / 5.0)
        if schedule is not None:
            n_active = schedule.to_sim().active[:rounds].sum(1)
        else:
            n_active = np.full(rounds, fed.n_clients)
        hist = {
            "data_loss": list(0.02 + 0.1 * decay * rng.rand(rounds)),
            "consensus_gap": list(decay * (1.0 + 0.1 * rng.rand(rounds))),
            "eps_all": list(0.5 + rng.rand(rounds, fed.n_clients)),
            "n_active": [float(n) for n in n_active],
        }
        return SimpleNamespace(z=None), None, hist

    def eval_rmse_mae(self, *args, **kwargs):
        rng = np.random.RandomState(1000 + self.evals)
        self.evals += 1
        return tuple(float(v) for v in 50.0 + 10.0 * rng.rand(2))

    def install(self, mod, monkeypatch) -> None:
        """Replace the module's training and evaluation calls."""
        for name in ("train_bafdp", "eval_rmse_mae"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, getattr(self, name))


def test_alias_is_not_installed_at_collection():
    """Collecting the port's tests must not make ``repro.core``
    importable: the reference's own broken test files stay as they are.
    (Checked in a fresh interpreter: this process may have run a fixture.)
    """
    import subprocess

    code = ("import sys; sys.path.insert(0, 'src'); "
            "import tests.test_torch_reference, jax.core; "
            "print(hasattr(jax.core, 'ClosedJaxpr'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO_ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "False"


def test_load_reference_imports_the_reference(reference):
    assert reference.bafdp.bafdp_round is not None
    assert reference.common.train_bafdp is not None


def test_state_round_trip_keeps_layout_and_dtypes(reference):
    """``fed_state_from_numpy`` keeps the nested layout, dtypes and
    values of the reference's initial state, in sorted-key leaf order."""
    from repro_torch.core.fed_state import fed_state_from_numpy

    r = reference
    cfg = r.configs.MLP_H1
    fed = r.configs.FedConfig(n_clients=3, omega_optimizer="adam",
                              staleness_compensation="taylor")
    ref_state = r.fed_state.init_fed_state(
        jax.random.PRNGKey(0),
        lambda k: r.forecasting.init_forecaster(k, cfg), fed)
    want = ref_state_arrays(ref_state)
    state = fed_state_from_numpy(want, device="cpu")
    assert list(state.W) == ["l0", "l1", "l2", "l3"]
    assert state.t.dtype == torch.int32 and state.tau.dtype == torch.int32
    assert state.W["l0"]["w"].dtype == torch.float32
    assert_states_close(port_state_arrays(state), want, rtol=0, atol=0)
    got_paths = [p for p, _ in flat_items(port_state_arrays(state)["W"])]
    ref_paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(ref_state.W)[0]]
    assert len(got_paths) == len(ref_paths) == 8
    for g, w in zip(got_paths, ref_paths):
        assert g.split("/")[1:] == [s.strip("[]'") for s in
                                    w.split("][")], (g, w)


@pytest.mark.parametrize("model", ["gru", "lstm", "attn"])
def test_state_round_trip_of_every_backbone(reference, model):
    """``fed_state_from_numpy`` carries the reference's state of a GRU,
    LSTM or attention forecaster (``w_x``, ``w_h``, ``b``, ``w_meta``,
    ``w_out.{w,b}``; ``w_emb``, ``w_q``, ``w_k``, ``w_v``) exactly, in
    sorted-key leaf order."""
    from repro_torch.core.fed_state import fed_state_from_numpy

    r = reference
    cfg = r.configs.ForecastConfig(model=model, rnn_hidden=8)
    fed = r.configs.FedConfig(n_clients=3, omega_optimizer="adam")
    ref_state = r.fed_state.init_fed_state(
        jax.random.PRNGKey(0),
        lambda k: r.forecasting.init_forecaster(k, cfg), fed)
    want = ref_state_arrays(ref_state)
    state = fed_state_from_numpy(want, device="cpu")
    assert_states_close(port_state_arrays(state), want, rtol=0, atol=0)
    got_paths = [p for p, _ in flat_items(port_state_arrays(state)["W"])]
    ref_paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(ref_state.W)[0]]
    assert [g.split("/")[1:] for g in got_paths] == [
        [s.strip("[]'") for s in w.split("][")] for w in ref_paths]


def test_fed_state_from_numpy_rejects_missing_fields():
    from repro_torch.core.fed_state import fed_state_from_numpy

    with pytest.raises(ValueError, match="missing"):
        fed_state_from_numpy({"W": {}}, device="cpu")
