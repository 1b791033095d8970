"""Checkpoints of the port (``repro_torch.checkpoint``) against the JAX
package's (``repro.checkpoint``) on the CPU, and the two entry points
that resume from them.

* A checkpoint moves between the packages in both directions bit for
  bit: a smoke LM ``FedState`` (an LM tree with its ``unit`` tuple,
  ``tau``, adam's ``opt``, bf16 leaves from a bf16 ``param_dtype``) with
  seeded values in every leaf, written by one package and restored by
  the other, equals ``fed_state_from_numpy`` of the same arrays.
* ``Checkpointer`` keeps the newest ``keep`` archives under the
  reference's names.
* ``federated_lm_training`` resumes at its label ``t + 1`` and trains only
  the rounds after it; ``launch.train --ckpt`` resumes at its label ``t``
  and runs round ``t`` again, as the reference's launcher does.
* A ``launch.train --smoke --ckpt`` archive written by either package's
  launcher resumes in both, and the two resumed runs agree.

The reference modules load through ``load_reference`` (the ``reference``
fixture), never at collection time.
"""
import dataclasses
import functools
import importlib
import os

import numpy as np
import pytest
import torch
from test_torch_reference import (  # noqa: F401  (fixture)
    flat_items, port_state_arrays, ref_state_arrays, reference)

from repro_torch import federated_lm_training as example
from repro_torch.checkpoint import Checkpointer, restore_pytree, save_pytree
from repro_torch.configs import get_arch, reduce_for_smoke
from repro_torch.core.fed_state import FedState, fed_state_from_numpy
from repro_torch.launch import steps
from repro_torch.launch import train as launcher
from repro_torch.tree import tree_map

ARCH = "gemma-7b"           # tied embeddings; smoke: 2 layers, one unit


def _seeded(arrays: dict, seed: int) -> dict:
    """``arrays`` (a state as numpy trees) with seeded values in every
    leaf, in each leaf's own dtype: normals for floats, small integers
    for ``t``, ``tau`` and the optimizer's count."""
    import jax

    rng = np.random.RandomState(seed)

    def fill(a):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            return rng.randint(0, 50, a.shape).astype(a.dtype)
        return rng.randn(*a.shape).astype(np.float32).astype(a.dtype)

    return {k: None if v is None else jax.tree.map(fill, v)
            for k, v in arrays.items()}


def _ref_state(r, seed):
    """The reference's smoke LM ``FedState`` (C=2, adam, bf16 params),
    narrowed to d 64 and a 256-token vocabulary (the archive's deflate
    is the test's cost), seeded; returns (jax state, numpy arrays)."""
    import jax
    import jax.numpy as jnp

    jcfg = dataclasses.replace(
        r.configs.reduce_for_smoke(r.configs.get_arch(ARCH)),
        param_dtype="bfloat16", d_model=64, d_ff=128, n_heads=2,
        n_kv_heads=1, head_dim=32, vocab_size=256)
    jtr = importlib.import_module("repro.models.transformer")
    jsteps = importlib.import_module("repro.launch.steps")
    fed = dataclasses.replace(jsteps.fed_config_for(jcfg, 2),
                              omega_optimizer="adam")
    shapes = jax.eval_shape(lambda: r.fed_state.init_fed_state(
        jax.random.PRNGKey(0), lambda k: jtr.init_lm(k, jcfg), fed))
    arrays = _seeded({k: None if v is None else jax.tree.map(
        lambda l: np.zeros(l.shape, l.dtype), v)
        for k, v in shapes._asdict().items()}, seed)
    jstate = r.fed_state.FedState(**{
        k: None if v is None else jax.tree.map(jnp.asarray, v)
        for k, v in arrays.items()})
    return jstate, arrays


def _arrays(state) -> dict:
    """The port's state as numpy trees (bf16 as f32, exactly)."""
    return {k: None if v is None else tree_map(
        lambda t: t.detach().float().numpy() if t.dtype == torch.bfloat16
        else t.detach().numpy().copy(), v)
        for k, v in state._asdict().items()}


def _bitwise(got: dict, want: dict) -> None:
    """Every leaf of two numpy state trees equal bit for bit, dtypes kept
    (bf16 read as its f32 value)."""
    g, w = dict(flat_items(got)), dict(flat_items(want))
    assert sorted(g) == sorted(w)
    for path in g:
        a, b = np.asarray(g[path]), np.asarray(w[path])
        assert a.shape == b.shape, path
        a, b = (x.astype(np.float32) if x.dtype.name == "bfloat16" else x
                for x in (a, b))
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert np.array_equal(a.reshape(-1).view(np.uint8),
                          b.reshape(-1).view(np.uint8)), path


def test_reference_checkpoint_restores_in_the_port(reference, tmp_path):
    jstate, arrays = _ref_state(reference, seed=1)
    jck = importlib.import_module("repro.checkpoint")
    path = jck.Checkpointer(str(tmp_path), keep=2).save(jstate, 7)
    want = fed_state_from_numpy(arrays, device="cpu")
    assert want.W["unit"][0]["attn"]["wq"].dtype == torch.bfloat16
    template = fed_state_from_numpy(_seeded(arrays, 2), device="cpu")
    got = restore_pytree(path, template)
    assert isinstance(got, FedState) and isinstance(got.W["unit"], tuple)
    assert got.comp is None and got.opt["count"].dtype == torch.int32
    _bitwise(_arrays(got), _arrays(want))
    restored, step = Checkpointer(str(tmp_path)).restore_latest(template)
    assert step == 7
    _bitwise(_arrays(restored), _arrays(want))


def test_port_checkpoint_restores_in_the_reference(reference, tmp_path):
    import jax

    jstate, arrays = _ref_state(reference, seed=3)
    state = fed_state_from_numpy(arrays, device="cpu")
    path = save_pytree(str(tmp_path / "step_000005.npz"), state, step=5)
    with open(path + ".meta.json") as f:
        assert f.read() == '{"step": 5}'
    jck = importlib.import_module("repro.checkpoint")
    template = jax.tree.map(lambda l: l * 0, jstate)
    got, step = jck.Checkpointer(str(tmp_path)).restore_latest(template)
    assert step == 5
    _bitwise(ref_state_arrays(got), arrays)
    assert str(got.W["unit"][0]["attn"]["wq"].dtype) == "bfloat16"


def test_restore_checks_shapes_and_takes_the_templates_dtype(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": (torch.tensor(3, dtype=torch.int32), None,
                  {"c": torch.tensor([0.5, -1.25], dtype=torch.bfloat16)})}
    path = save_pytree(str(tmp_path / "x.npz"), tree)
    data = np.load(path)
    assert sorted(data.files) == ["a", "b/0", "b/2/c"]
    assert data["b/2/c"].dtype == np.float32
    got = restore_pytree(path, tree)
    assert got["b"][1] is None and isinstance(got["b"], tuple)
    assert got["b"][2]["c"].dtype == torch.bfloat16
    assert torch.equal(got["b"][2]["c"], tree["b"][2]["c"])
    as64 = restore_pytree(path[:-4], {"a": tree["a"].double(),
                                      "b": tree["b"]})
    assert as64["a"].dtype == torch.float64
    with pytest.raises(AssertionError, match="'a'"):
        restore_pytree(path, {"a": torch.zeros(3, 2), "b": tree["b"]})


def test_checkpointer_keeps_the_newest(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"), keep=2)
    assert ck.latest_step() is None
    assert ck.restore_latest({"x": torch.zeros(2)}) == (None, None)
    for step in (3, 10, 7, 12):
        ck.save({"x": torch.full((2,), float(step))}, step)
    names = sorted(os.listdir(tmp_path / "ck"))
    assert names == ["step_000010.npz", "step_000010.npz.meta.json",
                     "step_000012.npz", "step_000012.npz.meta.json"]
    tree, step = ck.restore_latest({"x": torch.zeros(2)})
    assert step == 12 and tree["x"].tolist() == [12.0, 12.0]


SMALL = ["--clients", "2", "--batch", "1", "--seq", "32", "--device", "cpu"]
NARROW = dict(d_model=64, d_ff=128, n_heads=2, n_kv_heads=1, head_dim=32,
              vocab_size=256)


@pytest.fixture
def narrow(monkeypatch):
    """The entry points' smoke models narrowed to d 64 and a 256-token
    vocabulary: the resume tests count rounds and labels, and the smoke
    width's archives would take seconds each to deflate."""
    import repro_torch.configs as configs

    smoke, scale = configs.reduce_for_smoke, configs.scale_cfg
    monkeypatch.setattr(configs, "reduce_for_smoke", lambda cfg: (
        dataclasses.replace(smoke(cfg), **NARROW)))
    monkeypatch.setattr(example, "scale_cfg", lambda arch, s: (
        dataclasses.replace(scale(arch, s), **NARROW)))


def _record_rounds(monkeypatch, rounds) -> dict:
    """Wrap ``launch.steps.make_train_step`` so that the entry points'
    round function keeps, for each round ``t`` in ``rounds``, the state it
    is given (``("in", t)``) and the state it returns (``("out", t)``),
    as numpy trees."""
    seen, make = {}, steps.make_train_step

    def recording(cfg, fed, ranks=None):
        step = make(cfg, fed, ranks)

        def run(st, batch, seed, **kw):
            if seed in rounds:
                seen["in", seed] = port_state_arrays(st)
            new, m = step(st, batch, seed, **kw)
            if seed in rounds:
                seen["out", seed] = port_state_arrays(new)
            return new, m
        return run

    monkeypatch.setattr(steps, "make_train_step", recording)
    return seen


def test_example_resumes_after_its_label(tmp_path, monkeypatch, capsys,
                                        narrow):
    """Saved after round 100 under the label 101 and at the end under
    ``--steps`` 102; with the end's archive gone, as after a crash, the
    resume starts at 101 and trains round 101 only, from a state equal
    bit for bit to the one round 100 left; a resume at ``--steps`` trains
    nothing."""
    seen = _record_rounds(monkeypatch, {100, 101})
    ckpt = str(tmp_path / "ck")
    argv = SMALL + ["--steps", "102", "--ckpt", ckpt]
    first = example.train(example.parse_args(argv))
    assert first["rounds"] == list(range(102))
    assert Checkpointer(ckpt).latest_step() == 102
    after = seen.pop(("out", 100))
    seen.clear()
    for name in ("step_000102.npz", "step_000102.npz.meta.json"):
        os.remove(os.path.join(ckpt, name))
    capsys.readouterr()
    second = example.train(example.parse_args(argv))
    assert "resumed from step 101" in capsys.readouterr().out
    assert second["rounds"] == [101]
    _bitwise(seen["in", 101], after)
    assert sorted(os.listdir(ckpt)) == [
        "step_000101.npz", "step_000101.npz.meta.json", "step_000102.npz",
        "step_000102.npz.meta.json"]
    third = example.train(example.parse_args(argv))
    assert "already at step 102" in capsys.readouterr().out
    assert third["rounds"] == []


def _ran(out: str) -> list:
    """The rounds a launcher's ``--log-every 1`` output logged."""
    return [int(l.split()[1]) for l in out.splitlines()
            if l.startswith("step")]


def test_launcher_resumes_at_its_label(tmp_path, monkeypatch, capsys,
                                       narrow):
    """``launch.train --ckpt`` saves after round 50 under the label 50 and
    at the end under ``--steps`` 52, so a resume from 50 runs round 50
    again, from the state round 50 left (ROADMAP reference behaviour
    10)."""
    seen = _record_rounds(monkeypatch, {50})
    ckpt = str(tmp_path / "ck")
    argv = ["--arch", "smollm-360m", "--smoke", "--log-every", "1",
            "--device", "cpu", "--ckpt", ckpt, "--steps", "52"]
    assert launcher.main(argv) == 0
    assert _ran(capsys.readouterr().out) == list(range(52))
    ck = Checkpointer(ckpt)
    assert [s for s, _ in ck._paths()] == [50, 52]
    after = seen.pop(("out", 50))
    seen.clear()
    os.remove(os.path.join(ckpt, "step_000052.npz"))
    assert launcher.main(argv) == 0
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "resumed at step 50"
    assert _ran(out) == [50, 51]
    _bitwise(seen["in", 50], after)
    assert ck.latest_step() == 52


# the launchers' federated config in the cross-package resume: the LDP
# noise below rounding (privacy_budget_a 1e18: sigma ~ 5e-19, as in
# test_torch_lm_train.test_make_train_step_matches_reference) and every
# client active, so that no draw, which the two frameworks cannot share,
# reaches the state
QUIET = dict(privacy_budget_a=1e18, active_frac=1.0)
LOSS_ATOL = 1e-4     # the launchers print the loss to 4 decimals


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_launcher_resumes_the_other_packages_checkpoint(
        writer, reference, tmp_path, monkeypatch, capsys, narrow):
    """``launch.train --arch smollm-360m --smoke --ckpt``: ``writer``'s
    launcher trains rounds 0-2 and saves under 3.  Each package's launcher
    resumes a copy of that archive to ``--steps`` 4, then to 5 (rounds 3
    and 4).  The printed losses agree within LOSS_ATOL and the archives at
    4 and 5 within ``test_torch_lm_train._compare``'s bounds (rtol 2e-5,
    atol 1e-6 except on at most MAX_TIES tied coordinates)."""
    import shutil
    import sys

    from test_torch_lm_train import _compare

    import repro_torch.configs as configs
    from repro_torch.core.fed_state import init_fed_state, init_lm_tree

    jconfigs = importlib.import_module("repro.configs")
    jsteps = importlib.import_module("repro.launch.steps")
    jtrain = importlib.import_module("repro.launch.train")
    smoke = jconfigs.reduce_for_smoke
    monkeypatch.setattr(jconfigs, "reduce_for_smoke", lambda cfg: (
        dataclasses.replace(smoke(cfg), **NARROW)))
    for mod in (jsteps, steps):
        monkeypatch.setattr(mod, "fed_config_for", functools.partial(
            lambda f, cfg, n, base=None: dataclasses.replace(
                f(cfg, n, base), **QUIET), mod.fed_config_for))
    argv = ["--arch", "smollm-360m", "--smoke", "--log-every", "1"]

    def run(package, ckpt, n):
        if package == "reference":
            monkeypatch.setattr(sys, "argv", ["train"] + argv + [
                "--ckpt", ckpt, "--steps", str(n)])
            assert jtrain.main() == 0
        else:
            assert launcher.main(argv + ["--device", "cpu", "--ckpt", ckpt,
                                         "--steps", str(n)]) == 0
        out = capsys.readouterr().out
        return _ran(out), [float(l.split("loss=")[1].split()[0])
                           for l in out.splitlines() if l.startswith("step")]

    first = str(tmp_path / "first")
    assert run(writer, first, 3)[0] == [0, 1, 2]
    cfg = configs.reduce_for_smoke(get_arch("smollm-360m"))
    fed = steps.fed_config_for(cfg, 2)
    template = init_fed_state(torch.Generator().manual_seed(0),
                              lambda g: init_lm_tree(g, cfg, "cpu"), fed,
                              device="cpu")

    def archive(ckpt, step):
        return port_state_arrays(restore_pytree(
            os.path.join(ckpt, f"step_{step:06d}.npz"), template))

    init = archive(first, 3)
    states, losses = {}, {}
    for package in ("reference", "port"):
        ckpt = str(tmp_path / package)
        shutil.copytree(first, ckpt)
        losses[package] = []
        for n in (4, 5):
            ran, loss = run(package, ckpt, n)
            assert ran == [n - 1], (package, n, ran)
            losses[package] += loss
        states[package] = [archive(ckpt, n) for n in (4, 5)]
    np.testing.assert_allclose(losses["port"], losses["reference"], rtol=0,
                               atol=LOSS_ATOL)
    _compare(init, states["port"], [{}, {}], states["reference"], [{}, {}],
             fed)


def test_decode_window_is_the_references(reference):
    """``decode_window``: the sliding window past 65,536 positions
    (``long_500k``), else 0, for every architecture and input shape."""
    from repro_torch.configs import ARCHS, INPUT_SHAPES

    jsteps = importlib.import_module("repro.launch.steps")
    for arch in sorted(ARCHS):
        for name, shape in INPUT_SHAPES.items():
            want = jsteps.decode_window(reference.configs.get_arch(arch),
                                        reference.configs.INPUT_SHAPES[name])
            assert steps.decode_window(get_arch(arch), shape) == want
    assert steps.decode_window(get_arch("gemma-7b"),
                               INPUT_SHAPES["long_500k"]) == 8192
    assert steps.decode_window(reduce_for_smoke(get_arch("gemma-7b")),
                               INPUT_SHAPES["decode_32k"]) == 0
