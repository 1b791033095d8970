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
    """``(path, leaf)`` pairs of a nested dict in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_items(tree[k], f"{prefix}/{k}")
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


def test_fed_state_from_numpy_rejects_missing_fields():
    from repro_torch.core.fed_state import fed_state_from_numpy

    with pytest.raises(ValueError, match="missing"):
        fed_state_from_numpy({"W": {}}, device="cpu")
