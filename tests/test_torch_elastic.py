"""Elastic re-meshing and checkpoints across layouts (ROADMAP C9), on
spawned gloo worlds.

Each world of more than one rank runs in spawned processes over a
``FileStore`` under ``tmp_path`` and is destroyed at the end; rank 0
writes what it saw (full tensors, gathered from the shards) to a pickle.
One-rank parts run in this process. The state is ``qwen3-0.6b-smoke``'s
train state (float32 parameters and moments), placed by
``tree_shardings(..., PARAM_RULES)`` as ``launch.train.run`` places it.

* ``ElasticMeshManager.reshard`` of a placed state onto ``shrink(mesh,
  lost)``: 4 -> 2 ranks (data 4 -> 2), 4 -> 2 (data 2 x model 2 -> data 1
  x model 2) and 2 -> 1 (a plain state on the survivor): every leaf, in
  full, equal to the state before, on every survivor.
* A checkpoint written by ``launch.train.run`` on 2 ranks restored on 1
  rank and on 4 (``model=2``), and one written on 1 rank restored on 2:
  the restored leaves, in full, bit-identical to the written ones; the
  run resumed from it bit-identical to the same world's run resumed from
  the same values checkpointed on its own layout, and its losses within
  rtol 1e-5 of the writer's uninterrupted run (another world sums in
  another order).
* A ``repro``-written checkpoint restored onto a placed 2-rank template,
  bit for bit.
* A template of another shape raises ``ValueError`` naming the key, and
  a 2-rank checkpoint without block offsets (the format before they were
  recorded) restored on 1 rank raises; ``launch.train.run`` on it raises
  instead of retrying without end, under a timeout of its own.
"""
import json
import multiprocessing as mp
import os
import pickle
import shutil
import time
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from torch.distributed.tensor import DTensor  # noqa: E402

import repro_torch.train as TT  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    restore_pytree, save_pytree)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.ft import ElasticMeshManager  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.models.builder import tree_flatten  # noqa: E402
from repro_torch.sharding.partition import (PARAM_RULES,  # noqa: E402
                                            place_tree, tree_shardings)

ARCH = "qwen3-0.6b-smoke"
RUN = dict(steps=4, batch=4, seq=16, log_every=1000, device="cpu")
RESUME_AT = 2        # the step a resumed run starts from


def _full(x):
    x = x.full_tensor() if isinstance(x, DTensor) else x
    return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
        else x.numpy()


def full_tree(tree):
    return {k: _full(x) for k, x in tree_flatten(tree)}


def initial_state(seed=0):
    """(state, axes) as ``run`` initialises them for ``ARCH``."""
    cfg = get_config(ARCH)
    low = "float32" if cfg.param_dtype == "float32" else "bfloat16"
    oc = TT.OptConfig(m_dtype=low, v_dtype=low, grad_dtype=low)
    return TT.init_train_state(
        cfg, oc, torch.Generator("cpu").manual_seed(seed), device="cpu")


def state_and_shardings(mesh, seed=0):
    """``run``'s initial state for ``ARCH`` and its shardings on
    ``mesh``."""
    state, axes = initial_state(seed)
    return state, tree_shardings(state, axes, mesh, PARAM_RULES)


def keep_only(src, dst, step):
    """A copy of checkpoint directory ``src`` holding only ``step``."""
    name = f"step_{step:08d}"
    os.makedirs(dst)
    shutil.copytree(os.path.join(src, name), os.path.join(dst, name))
    return dst


def written(ckpt_dir):
    """(uninterrupted loss history, full values of step ``RESUME_AT``
    restored on the writer's own layout) of a ``run`` with a checkpoint
    every step: the writer's side of the resume checks."""
    history = run(ARCH, ckpt_dir=ckpt_dir, ckpt_every=1, **RUN)[1]
    mesh = make_host_mesh(1, "cpu")
    state, sh = state_and_shardings(mesh)
    template = place_tree(state, sh)
    got, _ = restore_pytree(ckpt_dir, RESUME_AT, template,
                            dist.get_rank())
    return history, full_tree(got)


def resume(src, work, model, rank):
    """Restore step ``RESUME_AT`` of ``src`` onto this world's placed
    state (full values), then two resumed runs from step ``RESUME_AT``:
    from ``src``'s files, and from the same values checkpointed on this
    world's own layout."""
    mesh = make_host_mesh(model, "cpu")
    state, sh = state_and_shardings(mesh, seed=1)
    restored, extra = restore_pytree(src, RESUME_AT, place_tree(state, sh),
                                     rank)
    own = os.path.join(work, "own")
    CheckpointManager(own).save(RESUME_AT, restored, extra)
    out = {"restored": full_tree(restored), "extra": extra}
    cross = os.path.join(work, "cross")
    if rank == 0:
        keep_only(src, cross, RESUME_AT)
    dist.barrier()
    for name, d in (("cross", cross), ("own", own)):
        st, history, report = run(ARCH, ckpt_dir=d, model_parallel=model,
                                  ckpt_every=100, **RUN)
        out[name] = (history, full_tree(st.params), report.restarts)
    return out


def reshard_case(model, lost):
    """A placed state resharded onto ``shrink(mesh, lost)``: (full values
    before, full values after on this rank or None off the new mesh, the
    types of the new leaves)."""
    em = ElasticMeshManager(model_parallel=model, device="cpu")
    mesh = em.build()
    state, sh = state_and_shardings(mesh)
    placed = place_tree(state, sh)
    want = full_tree(placed)
    small = em.shrink(mesh, lost)
    got = em.reshard(placed, tree_shardings(
        state, TT.train_state_axes(get_config(ARCH)), small, PARAM_RULES))
    if dist.get_rank() not in small.mesh.reshape(-1).tolist():
        return want, None, None
    return want, full_tree(got), sorted({
        "dtensor" if isinstance(x, DTensor) else type(x).__name__
        for _, x in tree_flatten(got)})


def _rank_main(rank, world, store_path, out_path, task):
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        out = {}
        for name, (fn, args) in task.items():
            out[name] = globals()[fn](*args, **({"rank": rank}
                                                if fn == "resume" else {}))
            dist.barrier()
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out_path}.{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(tmp_path, world, task, timeout=300):
    ctx = mp.get_context("spawn")
    out = str(tmp_path / f"rank0_{world}.pkl")
    store = str(tmp_path / f"store_{world}")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, out, task))
             for r in range(world)]
    for p in procs:
        p.start()
    errs = [f"{out}.{r}.err" for r in range(world)]
    try:
        end = time.monotonic() + timeout
        while any(p.is_alive() for p in procs) and time.monotonic() < end \
                and not any(map(os.path.exists, errs)):
            time.sleep(0.2)     # a failed rank leaves the others waiting
        for p in procs:
            p.join(timeout=5)
        for err in errs:
            assert not os.path.exists(err), open(err).read()
        assert not any(p.is_alive() for p in procs), "a rank hung"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r in range(world):
        err = f"{out}.{r}.err"
        assert not os.path.exists(err), open(err).read()
        assert procs[r].exitcode == 0
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every world of the module, in the order the checkpoints need: a
    one-rank writer here, then 2 ranks (reshard 2 -> 1, a writer, resume
    the one-rank checkpoint), then one rank and 4 ranks resuming the
    2-rank checkpoint (the 4-rank world also reshards)."""
    tmp = tmp_path_factory.mktemp("elastic")
    if dist.is_initialized():
        dist.destroy_process_group()
    one = str(tmp / "ckpt_1")
    res = {"w1": written(one)}
    dist.destroy_process_group()
    two = str(tmp / "ckpt_2")
    os.makedirs(tmp / "r2")
    res[2] = spawn(tmp, 2, {
        "reshard": ("reshard_case", (1, 1)),
        "written": ("written", (two,)),
        "resume": ("resume", (one, str(tmp / "r2"), 1))})
    os.makedirs(tmp / "r1")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        res[1] = {"resume": resume(two, str(tmp / "r1"), 1, 0)}
    finally:
        dist.destroy_process_group()
    os.makedirs(tmp / "r4")
    res[4] = spawn(tmp, 4, {
        "reshard": ("reshard_case", (1, 2)),
        "reshard_tp": ("reshard_case", (2, 2)),
        "resume": ("resume", (two, str(tmp / "r4"), 2))})
    res["ckpt_2"] = two
    return res


@pytest.mark.parametrize("world,case", [(4, "reshard"), (4, "reshard_tp"),
                                        (2, "reshard")])
def test_reshard_onto_a_shrunk_mesh_keeps_every_value(worlds, world, case):
    want, got, kinds = worlds[world][case]
    assert got is not None            # rank 0 survives every shrink
    assert got.keys() == want.keys()
    for key, x in got.items():
        np.testing.assert_array_equal(x, want[key], err_msg=key)
    # onto one rank the state comes back plain, else as DTensors
    assert kinds == (["Tensor"] if world == 2 else ["dtensor"])


@pytest.mark.parametrize("writer,reader", [(2, 1), (2, 4), (1, 2)])
def test_checkpoint_resumes_on_another_layout(worlds, writer, reader):
    history, at_step = (worlds["w1"] if writer == 1
                        else worlds[2]["written"])
    got = worlds[reader]["resume"]
    assert got["extra"] == {"step": RESUME_AT}
    assert got["restored"].keys() == at_step.keys()
    for key, x in got["restored"].items():
        np.testing.assert_array_equal(x, at_step[key], err_msg=key)
    cross, own = got["cross"], got["own"]
    assert len(cross[0]) == RUN["steps"] - RESUME_AT and cross[2] == 0
    assert cross[0] == own[0]
    assert cross[1].keys() == own[1].keys()
    for key, x in cross[1].items():
        np.testing.assert_array_equal(x, own[1][key], err_msg=key)
    np.testing.assert_allclose(cross[0], history[RESUME_AT:], rtol=1e-5)


def test_repro_checkpoint_restores_onto_a_placed_template(tmp_path):
    jax = pytest.importorskip("jax")
    import repro.configs as JC
    import repro.train as JT
    from repro.train.train_loop import init_train_state as j_init
    from repro.checkpoint import save_pytree as j_save
    jcfg = JC.get_config(ARCH)
    low = "float32" if jcfg.param_dtype == "float32" else "bfloat16"
    jstate, _ = j_init(jcfg, JT.OptConfig(
        m_dtype=low, v_dtype=low, grad_dtype=low), jax.random.PRNGKey(3))
    j_save(str(tmp_path / "j"), 5, jstate, extra={"step": 5})
    got = spawn(tmp_path, 2, {"r": ("restore_placed",
                                    (str(tmp_path / "j"), 5))})["r"]
    want = {k: np.asarray(v) for k, v in tree_flatten(
        jax.tree.map(np.asarray, jstate))}
    assert got.keys() == want.keys()
    for key, x in got.items():
        w = want[key]
        w = w.view(np.int16) if w.dtype.name == "bfloat16" else w
        np.testing.assert_array_equal(x, w, err_msg=key)


def restore_placed(directory, step):
    """``directory``'s ``step`` restored onto this world's placed state
    (every leaf a DTensor, ``model=2`` where the world allows), full."""
    mesh = make_host_mesh(2 if dist.get_world_size() % 2 == 0 else 1,
                          "cpu")
    state, sh = state_and_shardings(mesh)
    template = place_tree(state, sh, dtensor=True)
    got, _ = restore_pytree(directory, step, template, dist.get_rank())
    assert all(isinstance(x, DTensor) for _, x in tree_flatten(got))
    return full_tree(got)


def test_mismatched_template_raises_naming_the_key(tmp_path):
    save_pytree(str(tmp_path), 1, {"a": torch.zeros(3),
                                   "b": {"w": torch.ones(2, 4)}})
    with pytest.raises(ValueError, match="b__w"):
        restore_pytree(str(tmp_path), 1, {"a": torch.zeros(3),
                                          "b": {"w": torch.ones(4, 2)}})
    with pytest.raises(ValueError, match="a"):
        restore_pytree(str(tmp_path), 1, {"a": np.zeros(()),
                                          "b": {"w": torch.ones(2, 4)}})
    with pytest.raises(ValueError, match="b__w.*float32.*bfloat16"):
        restore_pytree(str(tmp_path), 1, {
            "a": torch.zeros(3),
            "b": {"w": torch.ones(2, 4, dtype=torch.bfloat16)}})
    with pytest.raises(ValueError, match="a.*float32.*float64"):
        restore_pytree(str(tmp_path), 1, {"a": np.zeros(3),
                                          "b": {"w": torch.ones(2, 4)}})


def _run_on_old_checkpoint(ckpt_dir, out_path):
    try:
        run(ARCH, ckpt_dir=ckpt_dir, ckpt_every=1, **RUN)
        result = "returned"
    except ValueError as e:
        result = f"ValueError: {e}"
    with open(out_path, "w") as f:
        f.write(result)


def test_checkpoint_without_offsets_on_another_layout_raises(worlds,
                                                             tmp_path):
    """A 2-rank step whose manifest has no block offsets (as written
    before they were recorded) on one rank: ``restore_pytree`` raises on
    the first leaf whose shard is not whole, and ``run`` raises out of
    its restart loop rather than restoring the same shards again without
    end."""
    old = keep_only(worlds["ckpt_2"], str(tmp_path / "old"), RESUME_AT)
    path = os.path.join(old, f"step_{RESUME_AT:08d}", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    del manifest["blocks"]
    with open(path, "w") as f:
        json.dump(manifest, f)
    template = initial_state()[0]
    with pytest.raises(ValueError, match="without block offsets"):
        restore_pytree(old, RESUME_AT, template)
    out = str(tmp_path / "run.txt")
    p = mp.get_context("spawn").Process(target=_run_on_old_checkpoint,
                                        args=(old, out))
    p.start()
    p.join(timeout=120)
    alive = p.is_alive()
    if alive:
        p.kill()
        p.join()
    assert not alive, "run kept restoring a checkpoint it cannot take"
    assert open(out).read().startswith("ValueError")
