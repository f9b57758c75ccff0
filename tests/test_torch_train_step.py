"""Port vs reference: ``make_train_step`` (gradients, microbatches, AdamW
in place) and its data-parallel form.

Both packages start from ``repro``'s ``init_train_state``, carried across
by ``convert.train_state_from_jax``, and take the same ``SyntheticLMData``
batches. Tolerances:

* float32, one and three steps, microbatches 1 and 2, for a dense
  (qwen3, internlm2), an MLA + MoE (deepseek-v3) and a hybrid SSM
  (zamba2) config: parameters within rtol 1e-4, atol 1e-6 (a thousandth
  of the lr = 1e-3 update), loss and grad norm within rtol 1e-5. These
  steps use ``eps = 1e-3``: with the default 1e-8, Adam maps a gradient
  of size ~eps to an update anywhere in (-lr, lr), so the ~1e-8 absolute
  differences of two summation orders (``test_torch_train.py``) move
  such elements by up to a fifth of an update (seen: 1.9e-4 at lr 1e-3
  in internlm2). With eps = 1e-3 an update moves at most lr / eps per
  unit of gradient, and every other term of the arithmetic is the same.
* bfloat16 ``qwen3-0.6b-smoke``, one step against ``repro`` compiled with
  excess precision off (ROADMAP C fact 9): at least 99 % of the
  parameters bit-equal; the rest one bfloat16 ulp (2**-7 relative) apart,
  or, where a gradient near zero rounds to opposite signs in the two
  backward passes, within 2.1 x lr (seen: 101 of 119,200 differ).
* ``microbatches=4`` against 1 on the port: rtol 2e-4, atol 2e-5, the
  reference test's bound.
* two gloo ranks (data parallelism) against one rank on the full batch:
  the same bound; on the same ranks, ``ElasticMeshManager.shrink``
  drops the lost rank's data row. Averaging the ranks' gradients equals the full batch's
  only while each rank holds as many valid labels as the others, which
  synthetic data (no ignored label) gives.
"""
import multiprocessing as mp
import os
import pickle
import traceback
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.train as JT  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402
from repro.train.train_loop import init_train_state as j_init_state  # noqa: E402,E501
from repro.train.train_loop import make_train_step as j_make_step  # noqa: E402,E501

import repro_torch.train as TT  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.convert import train_state_from_jax  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.ft import ElasticMeshManager  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.builder import tree_leaves  # noqa: E402

XLA_OPTIONS = {"xla_allow_excess_precision": False,
               "xla_backend_optimization_level": 0}
LR = 1e-3


def as_np(x):
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def params_np(params):
    return {p: as_np(x) for p, x in tree_leaves(params)}


def both(name, dtype, eps=1e-3):
    """Both configs, both optimizer configs and repro's initial state
    with its port copy."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    jc, tc = jax_config(name).replace(**kw), torch_config(name).replace(**kw)
    okw = dict(lr=LR, warmup_steps=0, total_steps=10, eps=eps,
               m_dtype=dtype, v_dtype=dtype, grad_dtype=dtype)
    joc, oc = JT.OptConfig(**okw), TT.OptConfig(**okw)
    jstate, _ = j_init_state(jc, joc, jax.random.PRNGKey(1))
    return jc, tc, joc, oc, jstate, train_state_from_jax(jstate, tc, "cpu")


def jax_step(jc, joc, mb, state, batch):
    """repro's train step as one compiled program (rounding every op)."""
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    return jax.jit(j_make_step(jc, joc, mb)).lower(state, b).compile(
        compiler_options=XLA_OPTIONS)


def test_train_state_carries_across_bit_for_bit():
    jc, tc, _, _, jstate, tstate = both("qwen3-0.6b-smoke", "bfloat16")
    assert int(tstate.step) == int(tstate.opt["step"]) == 0
    assert tstate.step.shape == () and tstate.step.dtype == torch.int32
    for got, want in ((tstate.params, jstate.params),
                      (tstate.opt["m"], jstate.opt["m"]),
                      (tstate.opt["v"], jstate.opt["v"])):
        want = dict(tree_leaves(jax.tree.map(np.asarray, want)))
        for path, x in tree_leaves(got):
            assert x.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                x.view(torch.int16).numpy(), want[path].view(np.int16))


STEP_CASES = [(n, mb) for n in ("qwen3-0.6b-smoke", "internlm2-1.8b-smoke",
                                "deepseek-v3-671b-smoke",
                                "zamba2-1.2b-smoke") for mb in (1, 2)]


@pytest.mark.parametrize("name,microbatches", STEP_CASES,
                         ids=[f"{n}-mb{m}" for n, m in STEP_CASES])
def test_train_steps_match_repro_f32(name, microbatches):
    jc, tc, joc, oc, jstate, tstate = both(name, "float32")
    data = SyntheticLMData(tc, DataConfig(16, 4, seed=5))
    jdata = JData(jc, JDataConfig(16, 4, seed=5))
    step = TT.make_train_step(tc, oc, microbatches)
    compiled = jax_step(jc, joc, microbatches, jstate, jdata.batch_at(0))
    for i in range(3):
        jstate, jm = compiled(jstate, {k: jnp.asarray(v) for k, v in
                                       jdata.batch_at(i).items()})
        tstate, tm = step(tstate, data.batch_at(i))
        if i in (0, 2):
            want = params_np(jax.tree.map(np.asarray, jstate.params))
            for path, x in params_np(tstate.params).items():
                np.testing.assert_allclose(x, want[path], rtol=1e-4,
                                           atol=1e-6, err_msg=str(path))
        for key in ("loss", "xent", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, atol=1e-7, err_msg=key)
        assert int(tm["tokens"]) == int(jm["tokens"])
    assert int(tstate.step) == int(tstate.opt["step"]) == 3


def test_bf16_qwen3_step_matches_repro():
    jc, tc, joc, oc, jstate, tstate = both("qwen3-0.6b-smoke", "bfloat16",
                                           eps=1e-8)
    batch = SyntheticLMData(tc, DataConfig(16, 4, seed=5)).batch_at(0)
    jstate, jm = jax_step(jc, joc, 1, jstate, batch)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate, tm = TT.make_train_step(tc, oc)(tstate, batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-3)
    want = params_np(jax.tree.map(np.asarray, jstate.params))
    differ = total = 0
    for path, x in tree_leaves(tstate.params):
        assert x.dtype == torch.bfloat16
        got = as_np(x)
        np.testing.assert_allclose(got, want[path], rtol=2.0 ** -7,
                                   atol=2.1 * LR, err_msg=str(path))
        differ += int((got != want[path]).sum())
        total += got.size
    assert differ < 0.01 * total, (differ, total)


def test_microbatch_equivalence():
    """The reference's test on the port: internlm2, B = 8, 4 x 2."""
    cfg = torch_config("internlm2-1.8b-smoke")
    oc = TT.OptConfig(m_dtype="float32", v_dtype="float32",
                      grad_dtype="float32")
    gen = torch.Generator("cpu")
    state1, _ = TT.init_train_state(cfg, oc, gen.manual_seed(0),
                                    device="cpu")
    state2, _ = TT.init_train_state(cfg, oc, gen.manual_seed(0),
                                    device="cpu")
    batch = SyntheticLMData(cfg, DataConfig(32, 8)).batch_at(0)
    s1, m1 = TT.make_train_step(cfg, oc, microbatches=1)(state1, batch)
    s2, m2 = TT.make_train_step(cfg, oc, microbatches=4)(state2, batch)
    for (_, a), (_, b) in zip(tree_leaves(s1.params),
                              tree_leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_uneven_splits_and_a_model_axis_raise():
    cfg = torch_config("qwen3-0.6b-smoke")
    oc = TT.OptConfig()
    state, _ = TT.init_train_state(cfg, oc, device="cpu")
    batch = SyntheticLMData(cfg, DataConfig(8, 6)).batch_at(0)
    with pytest.raises(ValueError, match="microbatches"):
        TT.make_train_step(cfg, oc, microbatches=4)(state, batch)
    # a model axis above 1 no longer raises: the step places the state
    # (test_torch_placement.py runs it on gloo ranks)
    tp_mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                    shape=(1, 2), size=lambda: 2)
    assert callable(TT.make_train_step(cfg, oc, mesh=tp_mesh))


# ------------------------------------------------------------------ #
# Data parallelism: two spawned gloo ranks
# ------------------------------------------------------------------ #
DP_ARCH = "qwen3-0.6b-smoke"
DP_STEPS = 2


def dp_run(mesh):
    """Two steps on the full 8-sequence batches, from a seeded init; the
    mesh's data ranks split each batch."""
    cfg = torch_config(DP_ARCH).replace(param_dtype="float32",
                                        compute_dtype="float32")
    oc = TT.OptConfig(lr=LR, warmup_steps=0, m_dtype="float32",
                      v_dtype="float32", grad_dtype="float32")
    state, _ = TT.init_train_state(
        cfg, oc, torch.Generator("cpu").manual_seed(3), device="cpu")
    data = SyntheticLMData(cfg, DataConfig(16, 8, seed=1))
    step = TT.make_train_step(cfg, oc, mesh=mesh)
    losses = []
    for i in range(DP_STEPS):
        state, m = step(state, data.batch_at(i))
        losses.append((float(m["loss"]), int(m["tokens"])))
    return params_np(state.params), losses


def _dp_rank_main(rank, world, store_path, out_path):
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        mesh = make_host_mesh(device="cpu")
        params, losses = dp_run(mesh)
        # the elastic manager on the same world: shrink drops data rows,
        # and a lost rank of a TP pair leaves no whole group
        em = ElasticMeshManager(device="cpu")
        small = em.shrink(em.build(), 1)
        with pytest.raises(RuntimeError, match="whole TP group"):
            ElasticMeshManager(model_parallel=2, device="cpu").shrink(
                ElasticMeshManager(model_parallel=2, device="cpu").build(),
                1)
        with open(out_path, "wb") as f:
            pickle.dump(dict(params=params, losses=losses,
                             shape=tuple(mesh.shape),
                             small=small.mesh.tolist(),
                             coord=small.get_coordinate()), f)
        dist.destroy_process_group()
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def test_two_gloo_ranks_equal_one_rank_on_the_full_batch(tmp_path):
    world = 2
    ctx = mp.get_context("spawn")
    outs = [str(tmp_path / f"rank{r}.pkl") for r in range(world)]
    procs = [ctx.Process(target=_dp_rank_main, args=(
        r, world, str(tmp_path / "store"), outs[r])) for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=180)
        assert not any(p.is_alive() for p in procs), "a rank hung"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    for r, path in enumerate(outs):
        err = path + ".err"
        assert not os.path.exists(err), open(err).read()
        assert procs[r].exitcode == 0
    want, want_losses = dp_run(None)
    coords = []
    for path in outs:
        with open(path, "rb") as f:      # written by the ranks above
            res = pickle.load(f)
        assert res["shape"] == (2, 1) and res["small"] == [[0]]
        for key, x in res["params"].items():
            np.testing.assert_allclose(x, want[key], rtol=2e-4, atol=2e-5)
        for (loss, tokens), (wl, wt) in zip(res["losses"], want_losses):
            assert tokens == wt
            np.testing.assert_allclose(loss, wl, rtol=1e-5)
        coords.append(res["coord"])
    assert tuple(coords[0]) == (0, 0) and coords[1] is None  # rank 1 lost


def test_train_step_on_the_card_matches_the_cpu():
    """Card test: every smoke config's train step (f32, TF32 off, eps
    1e-3 as above) gives on the card what it gives on the CPU from the
    same state: parameters within rtol 1e-4, atol 1e-6, loss within rtol
    1e-5. Every block kind's backward runs on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro.configs import ASSIGNED
    from repro_torch.models.builder import tree_flatten, tree_unflatten
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ASSIGNED:
        tc = torch_config(arch + "-smoke").replace(param_dtype="float32",
                                                   compute_dtype="float32")
        oc = TT.OptConfig(lr=LR, warmup_steps=0, eps=1e-3,
                          m_dtype="float32", v_dtype="float32",
                          grad_dtype="float32")
        cpu, _ = TT.init_train_state(
            tc, oc, torch.Generator("cpu").manual_seed(4), device="cpu")
        card = tree_unflatten(cpu, [x.to("cuda") for _, x in
                                    tree_flatten(cpu)])
        batch = SyntheticLMData(tc, DataConfig(16, 4, seed=2)).batch_at(0)
        cpu, m_cpu = TT.make_train_step(tc, oc, 2)(cpu, batch)
        card, m_card = TT.make_train_step(tc, oc, 2)(card, batch)
        np.testing.assert_allclose(float(m_card["loss"]),
                                   float(m_cpu["loss"]), rtol=1e-5,
                                   err_msg=arch)
        want = params_np(cpu.params)
        for path, x in tree_leaves(card.params):
            assert x.is_cuda
            np.testing.assert_allclose(x.cpu().numpy(), want[path],
                                       rtol=1e-4, atol=1e-6,
                                       err_msg=f"{arch} {path}")
