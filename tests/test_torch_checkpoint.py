"""Port vs reference: checkpoints, the restart loop, the elastic mesh
manager, the sharding rules and the training driver.

* ``checkpoint/store``: round trip, ``latest_step``, an incomplete step
  ignored, ``keep`` GC, a writer's error re-raised by ``wait()``; and
  across packages. ``repro`` saves a ``TrainState`` with float32,
  bfloat16 and int32 leaves and the port restores it bit-exact; the port
  saves the same state and its files are ``repro``'s byte for byte
  (headers included), and ``repro``'s ``restore_pytree`` reads its
  float32 and int32 leaves bit-exact. ``repro`` cannot restore a
  bfloat16 leaf, its own or the port's: numpy has no cast from the
  ``'<V2'`` it reads back to ``bfloat16`` (ROADMAP C fact 10); the test
  holds that the same error meets both packages' files.
* ``ft``: the reference's ``resilient_loop`` drill; ``launch.train.run``
  with two injected failures ends bit-identical to the uninterrupted run
  on the CPU; ``ElasticMeshManager`` on one rank.
* ``sharding``: ``logical_to_spec`` equal to ``repro``'s on the
  reference test's cases and on every leaf of every full config's axes
  tree at meshes (16, 16), (2, 16, 16), (4, 1) and (1, 1).
* every new module imports with ``jax`` and ``repro`` blocked.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models as J  # noqa: E402
from repro.checkpoint import restore_pytree as j_restore  # noqa: E402
from repro.checkpoint import save_pytree as j_save  # noqa: E402
from repro.configs import ASSIGNED  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.sharding.partition import ACT_RULES as J_ACT  # noqa: E402
from repro.sharding.partition import PARAM_RULES as J_PARAM  # noqa: E402
from repro.sharding.partition import logical_to_spec as j_spec  # noqa: E402
from repro.train.train_loop import TrainState as JTrainState  # noqa: E402

import repro_torch.models as T  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    latest_step, restore_pytree,
                                    save_pytree)
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.ft import (ElasticMeshManager, StragglerMonitor,  # noqa: E402,E501
                            resilient_loop)
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.models.builder import tree_flatten, tree_leaves  # noqa: E402
from repro_torch.sharding import (ACT_RULES, PARAM_RULES,  # noqa: E402
                                  NamedSharding, constrain,
                                  logical_to_spec, mesh_context,
                                  tree_shardings)
from repro_torch.train import TrainState  # noqa: E402


@pytest.fixture
def no_world():
    """No process group before or after the test."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------------ #
# The store
# ------------------------------------------------------------------ #
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "b": [np.int32(7), np.ones(4, np.float16)],
            "c": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    save_pytree(str(tmp_path), 3, tree, extra={"note": "hi"})
    assert latest_step(str(tmp_path)) == 3
    restored, extra = restore_pytree(str(tmp_path), 3, tree)
    assert extra == {"note": "hi"}
    assert torch.equal(restored["a"]["w"], tree["a"]["w"])
    assert int(restored["b"][0]) == 7 and restored["b"][0].shape == ()
    assert restored["b"][1].dtype == torch.float16
    assert torch.equal(restored["c"], tree["c"])
    names = sorted(os.listdir(tmp_path / "step_00000003"))
    assert names == ["a__w.p0.npy", "b__0.p0.npy", "b__1.p0.npy",
                     "c.p0.npy", "manifest.json"]


def test_checkpoint_manager_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, {"x": torch.full((3,), float(s),
                                           dtype=torch.float64)})
    mgr.wait()
    assert latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    step, tree, _ = mgr.restore_latest({"x": torch.zeros(
        3, dtype=torch.float64)})
    assert step == 4 and tree["x"][0] == 4 and tree["x"].dtype == \
        torch.float64


def test_incomplete_checkpoint_ignored(tmp_path):
    save_pytree(str(tmp_path), 1, {"x": torch.zeros(2)})
    os.makedirs(tmp_path / "step_00000009")     # a writer killed mid-way
    assert latest_step(str(tmp_path)) == 1
    assert latest_step(str(tmp_path / "absent")) is None


def test_async_write_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("x")
    mgr = CheckpointManager(str(blocker))
    mgr.save_async(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                   # raised once, then clear


def test_async_snapshot_is_taken_at_the_call(tmp_path):
    """The train step updates in place: what lands is the value at
    ``save_async``, not a later one."""
    x = torch.zeros(4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"x": x})
    x += 5
    _, tree, _ = mgr.restore_latest({"x": x})
    assert torch.equal(tree["x"], torch.zeros(4))


# ------------------------------------------------------------------ #
# Across packages
# ------------------------------------------------------------------ #
def mixed_state(rng):
    """A TrainState-shaped tree in numpy with float32, bfloat16 and int32
    leaves (``ml_dtypes`` bfloat16 for ``repro``)."""
    import ml_dtypes
    w = rng.normal(size=(3, 4)).astype(np.float32)
    h = rng.normal(size=(5,)).astype(ml_dtypes.bfloat16)
    return ({"w": w, "h": h},
            {"m": {"w": w * 2, "h": h}, "v": {"w": w * w, "h": h},
             "step": np.int32(7)},
            np.int32(7))


def jax_state(parts):
    params, opt, step = parts
    return JTrainState(jax.tree.map(jnp.asarray, params),
                       jax.tree.map(jnp.asarray, opt), jnp.asarray(step))


def torch_state(parts):
    def conv(x):
        x = np.asarray(x)
        if x.dtype.name == "bfloat16":
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(x.copy())
    params, opt, step = parts
    return TrainState(
        {k: conv(v) for k, v in params.items()},
        {"m": {k: conv(v) for k, v in opt["m"].items()},
         "v": {k: conv(v) for k, v in opt["v"].items()},
         "step": conv(opt["step"])}, conv(step))


def bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def test_port_restores_repro_checkpoints_bit_exact(tmp_path):
    parts = mixed_state(np.random.default_rng(0))
    j_save(str(tmp_path), 5, jax_state(parts), extra={"step": 5})
    template = torch_state(parts)
    got, extra = restore_pytree(str(tmp_path), 5, template)
    assert extra == {"step": 5} and isinstance(got, TrainState)
    want = dict(tree_flatten(template))
    for key, x in tree_flatten(got):
        assert x.dtype == want[key].dtype and x.shape == want[key].shape
        np.testing.assert_array_equal(bits(x), bits(want[key]))


def test_repro_reads_port_checkpoints(tmp_path):
    parts = mixed_state(np.random.default_rng(1))
    j_save(str(tmp_path / "j"), 2, jax_state(parts), extra={"k": 1})
    save_pytree(str(tmp_path / "t"), 2, torch_state(parts), extra={"k": 1})
    jd, td = tmp_path / "j" / "step_00000002", tmp_path / "t" / \
        "step_00000002"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        a, b = (jd / name).read_bytes(), (td / name).read_bytes()
        if name == "manifest.json":
            import json
            assert json.loads(a) == json.loads(b)
        else:
            assert a == b, name                   # header and data
    # repro restores the float32 and int32 leaves of the port's files
    sub = {"w": jnp.zeros((3, 4), jnp.float32)}
    got, _ = j_restore(str(tmp_path / "t"), 2,
                       JTrainState(sub, {"m": sub, "v": sub,
                                         "step": jnp.int32(0)},
                                   jnp.int32(0)))
    np.testing.assert_array_equal(np.asarray(got.params["w"]),
                                  parts[0]["w"])
    np.testing.assert_array_equal(np.asarray(got.opt["v"]["w"]),
                                  parts[1]["v"]["w"])
    assert int(np.asarray(got.step)) == 7
    # ... and fails on a bfloat16 leaf, its own files' and the port's
    bf = JTrainState({"h": jnp.zeros((5,), jnp.bfloat16)},
                     {"m": {}, "v": {}, "step": jnp.int32(0)}, jnp.int32(0))
    for d in ("j", "t"):
        with pytest.raises(ValueError, match="No cast function"):
            j_restore(str(tmp_path / d), 2, bf)


# ------------------------------------------------------------------ #
# Fault tolerance
# ------------------------------------------------------------------ #
def test_resilient_loop_restart_bit_identical(tmp_path):
    """The reference's drill: a failure injected mid-run; the restarted
    run ends in the uninterrupted run's state."""
    def step(state, batch):
        s = state["s"] + batch["x"].sum()
        return {"s": s, "n": state["n"] + 1}, {"loss": s}

    def batch_at(i):
        return {"x": torch.full((4,), float(i + 1))}

    init = {"s": torch.tensor(0.0), "n": torch.tensor(0, dtype=torch.int32)}
    ref, _ = resilient_loop(step, init, batch_at, 30, str(tmp_path / "ref"),
                            ckpt_every=7)
    injected, rep = resilient_loop(
        step, init, batch_at, 30, str(tmp_path / "inj"), ckpt_every=7,
        fail_at={11: RuntimeError("node died"), 23: RuntimeError("again")})
    assert rep.restarts == 2 and rep.steps_run == 30 + 4 + 2
    assert float(injected["s"]) == float(ref["s"]) == 4 * 30 * 31 / 2
    assert int(injected["n"]) == int(ref["n"]) == 30
    assert rep.final_metrics == {"loss": float(ref["s"])}


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(window=8, factor=2.0)
    assert not any(mon.record(i, 0.1) for i in range(8))
    assert mon.record(9, 0.5) is True
    assert mon.record(10, 0.11) is False


def test_train_restart_resumes_bit_identical(tmp_path):
    """The reference's restart test, bit-exact on the CPU."""
    kw = dict(steps=12, batch=2, seq=32, ckpt_every=4, log_every=1000,
              device="cpu")
    s_ref, h_ref, rep_ref = run("qwen3-0.6b-smoke",
                                ckpt_dir=str(tmp_path / "ref"), **kw)
    s_inj, h_inj, rep = run("qwen3-0.6b-smoke",
                            ckpt_dir=str(tmp_path / "inj"),
                            fail_at={5: RuntimeError("kill"),
                                     9: RuntimeError("kill2")}, **kw)
    assert rep_ref.restarts == 0 and rep.restarts == 2
    assert len(h_ref) == 12 and len(h_inj) == 12 + 2 + 2
    assert int(s_inj.step) == int(s_ref.step) == 12
    for (pa, a), (pb, b) in zip(tree_flatten(s_ref), tree_flatten(s_inj)):
        assert pa == pb and torch.equal(a, b), pa
    assert not dist.is_initialized()            # run() tore its world down


def test_train_loop_loss_decreases():
    _, history, report = run("qwen3-0.6b-smoke", steps=20, batch=4, seq=64,
                             log_every=1000, device="cpu")
    assert report is None and len(history) == 20
    assert history[-1] < history[0], history


def test_elastic_mesh_manager_on_one_rank(no_world):
    em = ElasticMeshManager(model_parallel=1, device="cpu")
    mesh = em.build()
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    with pytest.raises(RuntimeError, match="whole TP group"):
        ElasticMeshManager(model_parallel=2, device="cpu").build()
    with pytest.raises(RuntimeError, match="whole TP group"):
        em.shrink(mesh, 1)
    # reshard: a one-rank mesh places every leaf on its device
    cfg = torch_config("qwen3-0.6b-smoke")
    params, axes = T.init_model(cfg, torch.Generator("cpu").manual_seed(0),
                                device="cpu")
    sh = tree_shardings(params, axes, mesh)
    placed = em.reshard(params, sh)
    for (_, a), (_, b) in zip(tree_leaves(params), tree_leaves(placed)):
        assert type(b) is torch.Tensor and torch.equal(a, b)
    assert all(s.spec == (None,) * len(s.spec) for _, s in tree_flatten(
        sh, is_leaf=lambda s: isinstance(s, NamedSharding)))


def test_meshes_larger_than_the_world_raise(no_world):
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="needs 32 ranks"):
        tmesh.make_elastic_mesh(2, 16, device="cpu")
    assert not dist.is_initialized()
    mesh = tmesh.make_host_mesh(device="cpu")
    assert tuple(mesh.shape) == (1, 1)
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        tmesh.make_host_mesh(model=2, device="cpu")


# ------------------------------------------------------------------ #
# Sharding rules
# ------------------------------------------------------------------ #
class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


REF_CASES = [
    ({"data": 16, "model": 16}, (1024, 6144), ("embed", "heads"), "param"),
    ({"data": 16, "model": 16}, (384, 384), ("embed", "heads"), "param"),
    ({"data": 16, "model": 16}, (10, 6), (None, "heads"), "param"),
    ({"data": 16, "model": 16}, (256, 128), ("act_batch", None), "act"),
    ({"pod": 2, "data": 16, "model": 16}, (256, 128), ("act_batch", None),
     "act"),
    ({"pod": 2, "data": 16, "model": 16}, (8, 128), ("act_batch", None),
     "act"),
]


@pytest.mark.parametrize("shape_,dims,axes,kind", REF_CASES)
def test_logical_to_spec_matches_repro_cases(shape_, dims, axes, kind):
    rules = (PARAM_RULES, J_PARAM) if kind == "param" else (ACT_RULES,
                                                           J_ACT)
    got = logical_to_spec(dims, axes, FakeMesh(shape_), rules[0])
    assert got == tuple(j_spec(dims, axes, FakeMesh(shape_), rules[1]))


MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4, "model": 1}, {"data": 1, "model": 1}]


@pytest.mark.parametrize("name", ASSIGNED)
def test_logical_to_spec_matches_repro_on_full_configs(name):
    tp, taxes = T.init_model(torch_config(name), abstract=True)
    jp, jaxes = J.init_model(jax_config(name), abstract=True)
    want_shapes = {tuple(k.key for k in path): leaf.shape for path, leaf
                   in jax.tree_util.tree_flatten_with_path(jp)[0]}
    axes = dict(tree_leaves(taxes))
    assert taxes == jaxes
    for shape in MESHES:
        mesh = FakeMesh(shape)
        for path, leaf in tree_leaves(tp):
            assert tuple(leaf.shape) == tuple(want_shapes[path])
            for ours, theirs in ((PARAM_RULES, J_PARAM),
                                 (ACT_RULES, J_ACT)):
                got = logical_to_spec(leaf.shape, axes[path], mesh, ours)
                want = j_spec(want_shapes[path], axes[path], mesh, theirs)
                assert got == tuple(want), (path, shape)


def test_constrain_is_the_identity_off_a_mesh(no_world):
    x = torch.ones(4, 2)
    assert constrain(x, ("act_batch", None)) is x
    mesh = tmesh.make_host_mesh(device="cpu")
    with mesh_context(mesh):
        assert constrain(x, ("act_batch", None)) is x   # not a DTensor
    from torch.distributed.tensor import Replicate, distribute_tensor
    d = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    with mesh_context(mesh):
        out = constrain(d, ("act_batch", None))
    assert torch.equal(out.full_tensor(), x)
    assert NamedSharding(mesh, ("data", None)).placements[0].dim == 0


# ------------------------------------------------------------------ #
# Import gate
# ------------------------------------------------------------------ #
def test_training_modules_import_without_jax():
    modules = ("repro_torch.data", "repro_torch.train",
               "repro_torch.checkpoint", "repro_torch.ft",
               "repro_torch.sharding", "repro_torch.launch.mesh",
               "repro_torch.launch.train", "repro_torch.convert")
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            f"import {', '.join(modules)}; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules if sys.modules[m] is not None), "
            "'imported the JAX package'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                       [p for p in sys.path if p])))
