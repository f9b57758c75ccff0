"""FSDP/TP placement of parameters: placed train steps and
``launch.train.run`` on spawned gloo ranks against one unplaced rank.

Each world runs in spawned processes over a ``FileStore`` under
``tmp_path`` and is destroyed at the end; rank 0 writes what it saw (full
tensors, gathered from the shards) to a pickle. The one-rank reference
runs here, unplaced (plain tensors, no mesh) — the step that
``test_torch_train_step.py`` holds against ``repro``. Tolerances:

* every block kind (GQA ``qwen3``, MLA ``deepseek-v3``, MoE
  ``llama4-scout``, SSM ``mamba2``, hybrid ``zamba2``, encoder-decoder
  ``whisper-tiny``, VLM ``internvl2``) in float32 with ``eps = 1e-3``
  (ROADMAP C fact 11) on a ``data 2 x model 2`` mesh: the loss and
  every parameter after one step within rtol 1e-5, atol 1e-6 (worst
  seen: 5.8e-9 past rtol 1e-5) — only the summation order differs; the
  forward logits within rtol 1e-5 and atol 2e-6 x the largest finite
  |logit|, since a product split over ``model`` sums its halves in
  another order and moves a logit by a few float32 ulps of the largest
  (seen: 1.9e-5 at a largest logit of 60 in qwen3, 4.3e-6 at 4.2 in
  deepseek-v3);
* placed prefill + decode (GQA and MLA caches, their length split over
  ``model``): logits and every cache leaf as the logits above (seen:
  1.7e-6 at a largest value of 2.0 in deepseek-v3's second latent cache),
  each leaf written in the same places;
* ``launch.train.run`` (``qwen3-0.6b-smoke``, float32, the default eps)
  on 2 ranks (data 2) and 4 ranks (data 2 x model 2), and on one rank
  with its state placed as DTensors all the same: each step's loss
  within rtol 1e-5 of one unplaced rank's;
* its restart drill on 2 and 4 ranks (a checkpoint every step, each rank
  writing its shards; a failure injected after step 1 computes): the
  replayed step's loss and the final parameters bit-identical to the
  same world's uninterrupted run.
"""
import contextlib
import json
import multiprocessing as mp
import os
import pickle
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from torch.distributed.tensor import DTensor, Shard  # noqa: E402

import repro_torch.train as TT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.models import (decode_step, forward, init_cache,  # noqa: E402,E501
                                init_model, prefill)
from repro_torch.models.builder import tree_flatten, tree_leaves  # noqa: E402,E501
from repro_torch.sharding.partition import (ACT_RULES, PARAM_RULES,  # noqa: E402,E501
                                            NamedSharding,
                                            logical_to_sharding,
                                            mesh_context, place_tree,
                                            tree_shardings)

KINDS = ["qwen3-0.6b", "deepseek-v3-671b", "llama4-scout-17b-a16e",
         "mamba2-2.7b", "zamba2-1.2b", "whisper-tiny", "internvl2-26b"]
SERVE_KINDS = ["qwen3-0.6b", "deepseek-v3-671b"]    # GQA, MLA caches
RUN = dict(steps=3, batch=4, seq=16, log_every=1000, device="cpu")


def _cfg(arch):
    return get_config(arch + "-smoke").replace(param_dtype="float32",
                                               compute_dtype="float32")


def _oc():
    return TT.OptConfig(lr=1e-3, warmup_steps=0, eps=1e-3,
                        m_dtype="float32", v_dtype="float32",
                        grad_dtype="float32")


def _full(x):
    return (x.full_tensor() if isinstance(x, DTensor) else x).numpy()


def one_step(arch, mesh=None):
    """Forward logits, then one train step, from a seeded init: (logits,
    loss, params, placements of every leaf of the placed state, wanted
    placements)."""
    cfg, oc = _cfg(arch), _oc()
    state, axes = TT.init_train_state(
        cfg, oc, torch.Generator("cpu").manual_seed(4), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in SyntheticLMData(
        cfg, DataConfig(16, 4, seed=2)).batch_at(0).items()}
    got = want = None
    if mesh is not None:
        sh = tree_shardings(state, axes, mesh, PARAM_RULES)
        state = place_tree(state, sh)
        want = [s.placements for _, s in tree_flatten(
            sh, is_leaf=lambda s: isinstance(s, NamedSharding))]
        with mesh_context(mesh):
            placed = {k: logical_to_sharding(
                v.shape, ("act_batch",) + (None,) * (v.ndim - 1), mesh,
                ACT_RULES).place(v) for k, v in batch.items()}
            logits, _ = forward(state.params, cfg, placed["tokens"],
                                placed.get("frontend"))
    else:
        logits, _ = forward(state.params, cfg, batch["tokens"],
                            batch.get("frontend"))
    logits = _full(logits.detach())
    state, m = TT.make_train_step(cfg, oc, mesh=mesh)(state, batch)
    if mesh is not None:
        got = [tuple(x.placements) if isinstance(x, DTensor) else None
               for _, x in tree_flatten(state)]
    params = {p: _full(x) for p, x in tree_leaves(state.params)}
    return logits, float(m["loss"]), params, got, want


def serve_once(arch, mesh=None):
    """Prefill 12 tokens into a cache of 16, then decode one: (prefill
    logits, decode logits, every cache leaf), full tensors."""
    cfg = _cfg(arch)
    params, axes = init_model(cfg, torch.Generator("cpu").manual_seed(4),
                              device="cpu")
    tokens = torch.as_tensor(SyntheticLMData(
        cfg, DataConfig(16, 4, seed=2)).batch_at(0)["tokens"])
    cache, cache_axes = init_cache(cfg, 4, 16, device="cpu")
    prompt, nxt = tokens[:, :12], tokens[:, 12:13]
    ctx = contextlib.nullcontext()
    if mesh is not None:
        params = place_tree(params, tree_shardings(params, axes, mesh,
                                                   PARAM_RULES))
        cache = place_tree(cache, tree_shardings(cache, cache_axes, mesh,
                                                 ACT_RULES))
        prompt, nxt = (logical_to_sharding(t.shape, ("act_batch", None),
                                           mesh, ACT_RULES).place(t)
                       for t in (prompt, nxt))
        ctx = mesh_context(mesh)
    with ctx, torch.no_grad():
        first, cache = prefill(params, cfg, prompt, cache)
        second, cache = decode_step(params, cfg, cache, nxt, 12)
    return (_full(first), _full(second),
            {p: _full(x) for p, x in tree_leaves(cache)})


def drill(model, ckpt_dir):
    """``launch.train.run`` with a checkpoint every step and a failure
    injected after step 1: (loss history, final parameters in full,
    files of the last step's directory, its manifest)."""
    state, history, report = run(
        "qwen3-0.6b-smoke", model_parallel=model, ckpt_dir=ckpt_dir,
        ckpt_every=1, fail_at={1: RuntimeError("injected")}, **RUN)
    assert report.restarts == 1
    last = os.path.join(ckpt_dir, f"step_{RUN['steps']:08d}")
    with open(os.path.join(last, "manifest.json")) as f:
        manifest = json.load(f)
    return (history, {p: _full(x) for p, x in tree_leaves(state.params)},
            sorted(os.listdir(last)), manifest)


def _rank_main(rank, world, model, store_path, out_path, archs):
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        out = {"steps": {a: one_step(a, make_host_mesh(model, "cpu"))
                         for a in archs},
               "serve": {a: serve_once(a, make_host_mesh(model, "cpu"))
                         for a in archs if a in SERVE_KINDS}}
        state, out["run"], _ = run("qwen3-0.6b-smoke",
                                   model_parallel=model, **RUN)
        out["run_params"] = {p: _full(x)
                             for p, x in tree_leaves(state.params)}
        out["drill"] = drill(model, os.path.join(
            os.path.dirname(store_path), "ckpt"))
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out_path}.{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(tmp_path, world, model, archs):
    ctx = mp.get_context("spawn")
    out = str(tmp_path / "rank0.pkl")
    procs = [ctx.Process(target=_rank_main, args=(
        r, world, model, str(tmp_path / "store"), out, archs))
        for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=240)
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
    with open(out, "rb") as f:      # written by rank 0 above
        return pickle.load(f)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("tp"), 4, 2, KINDS)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("dp"), 2, 1, [])


@pytest.fixture(scope="module")
def one_rank_run():
    return run("qwen3-0.6b-smoke", **RUN)[1]


@pytest.mark.parametrize("arch", KINDS)
def test_placed_step_on_four_ranks_equals_one_rank(four_ranks, arch):
    logits, loss, params, got, want = four_ranks["steps"][arch]
    w_logits, w_loss, w_params, _, _ = one_step(arch)
    finite = np.abs(w_logits[np.abs(w_logits) < 1e30])
    np.testing.assert_allclose(logits, w_logits, rtol=1e-5,
                               atol=2e-6 * finite.max())
    np.testing.assert_allclose(loss, w_loss, rtol=1e-5)
    assert params.keys() == w_params.keys()
    for path, x in params.items():
        np.testing.assert_allclose(x, w_params[path], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{arch} {path}")
    # every parameter, both moments and the step keep the placements
    # that tree_shardings gives
    assert got == [tuple(p) for p in want]
    assert any(isinstance(p, Shard) for pl in got for p in pl)


@pytest.mark.parametrize("arch", SERVE_KINDS)
def test_placed_serving_on_four_ranks_equals_one_rank(four_ranks, arch):
    """Prefill and decode with the cache's length split over ``model``
    (``cache_seq``): the writes land in the shards that own their
    positions, and logits and caches equal one rank's."""
    got = four_ranks["serve"][arch]
    want = serve_once(arch)
    for a, b in zip(got[:2], want[:2]):
        finite = np.abs(b[np.abs(b) < 1e30])
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=2e-6 * finite.max())
    assert got[2].keys() == want[2].keys()
    for path, x in got[2].items():
        w = want[2][path]
        assert np.count_nonzero(x) == np.count_nonzero(w) > 0
        np.testing.assert_allclose(x, w, rtol=1e-5,
                                   atol=2e-6 * np.abs(w).max(),
                                   err_msg=f"{arch} {path}")


def test_run_on_four_ranks_with_a_model_axis(four_ranks, one_rank_run):
    np.testing.assert_allclose(four_ranks["run"], one_rank_run, rtol=1e-5)


def test_run_on_two_data_ranks(two_ranks, one_rank_run):
    assert len(two_ranks["run"]) == RUN["steps"]
    np.testing.assert_allclose(two_ranks["run"], one_rank_run, rtol=1e-5)


def test_run_on_one_rank_through_the_placed_path(one_rank_run):
    """``dtensor=True``: every leaf a DTensor on a one-rank mesh, the
    path of a larger world, with one rank's losses."""
    state, history, _ = run("qwen3-0.6b-smoke", dtensor=True, **RUN)
    assert all(isinstance(x, DTensor) for _, x in tree_flatten(state))
    np.testing.assert_allclose(history, one_rank_run, rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4])
def test_restart_drill_on_placed_ranks(two_ranks, four_ranks, world):
    """Each rank checkpoints its own shards and restores them into its
    placements: the run replays step 1 and ends where the uninterrupted
    run of the same world ends."""
    res = {2: two_ranks, 4: four_ranks}[world]
    history, params, files, manifest = res["drill"]
    want = res["run"]
    assert len(history) == RUN["steps"] + 1
    np.testing.assert_array_equal(history[:2] + history[3:], want)
    assert history[2] == history[1]
    assert params.keys() == res["run_params"].keys()
    for path, x in params.items():
        np.testing.assert_array_equal(x, res["run_params"][path],
                                      err_msg=str(path))
    assert manifest["num_processes"] == world
    keys = manifest["keys"]
    assert files == sorted([f"{k}.p{r}.npy" for k in keys
                            for r in range(world)] + ["manifest.json"])
    # the manifest holds global shapes: the embedding's vocabulary is
    # split over model on 4 ranks, whole in the manifest
    cfg = get_config("qwen3-0.6b-smoke")
    assert manifest["shapes"]["0__embed"][0] == cfg.padded_vocab
