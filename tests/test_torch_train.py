"""Port vs reference: the training path (``data``, ``train``, ``loss_fn``
gradients, ``remat``).

Both packages start from the same numbers: numpy draws from one seed, or
``repro``'s weights carried across by ``convert.lm_params_from_jax``.
Train steps are in ``test_torch_train_step.py``. Tolerances:

* ``lr_schedule`` and ``global_norm``: rtol 1e-6 (float32 ops, one or
  two ulps apart);
* ``adamw_update``: float32 moments and parameters within rtol 1e-5,
  atol 1e-7; bfloat16 moments (and bfloat16 parameters) bit-equal;
* ``loss_fn`` gradients of every smoke config in float32: within rtol
  1e-4 and an atol of 1e-5 x the leaf's largest |gradient| (the two
  packages sum in different orders; the worst seen is 2.5e-6 of it);
* ``remat`` "full" / "dots" / "none" and the data pipeline: exact.
"""
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models as J  # noqa: E402
import repro.train as JT  # noqa: E402
from repro.configs import ASSIGNED  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLMData as JData  # noqa: E402

import repro_torch.models as T  # noqa: E402
import repro_torch.train as TT  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMData  # noqa: E402
from repro_torch.models.builder import tree_leaves  # noqa: E402

SMOKES = [a + "-smoke" for a in ASSIGNED]
XLA_OPTIONS = {"xla_allow_excess_precision": False,
               "xla_backend_optimization_level": 0}


def run_jax(fn, *args):
    """One XLA program that rounds every op to its dtype, as the port
    does (``test_torch_models.run_jax``)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=XLA_OPTIONS)(*args)


def configs(name, dtype="float32", **kw):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, **kw)
    return jax_config(name).replace(**kw), torch_config(name).replace(**kw)


def as_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def leaves_np(tree):
    return {p: as_np(x) for p, x in tree_leaves(tree)}


def jax_leaves_np(tree):
    return leaves_np(jax.tree.map(np.asarray, tree))


def make_batch(cfg, B=2, S=12, seed=2):
    """numpy tokens, labels (one ignored) and frontend frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    batch["labels"][0, -1] = -1
    if cfg.frontend != "none":
        batch["frontend"] = rng.normal(
            size=(B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ #
# Optimizer
# ------------------------------------------------------------------ #
def test_lr_schedule_matches_repro():
    oc = TT.OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                      min_lr_frac=0.1)
    joc = JT.OptConfig(lr=1.0, warmup_steps=10, total_steps=110,
                       min_lr_frac=0.1)
    steps = [0, 5, 10, 60, 110, 200]
    got = [float(TT.lr_schedule(oc, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(JT.lr_schedule(joc, jnp.int32(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.0 and abs(got[1] - 0.5) < 1e-6
    assert abs(got[2] - 1.0) < 1e-6 and 0.1 < got[3] < 1.0
    assert abs(got[4] - 0.1) < 1e-6 and abs(got[5] - 0.1) < 1e-6


def random_tree(rng, dtype=np.float32, scale=1.0):
    """A small parameter-like tree: matrices (decayed), a stacked
    3-d leaf and vectors (not decayed)."""
    shapes = {"a": {"w": (6, 5), "scale": (5,)}, "b": {"w": (2, 4, 3)},
              "bias": (7,)}

    def draw(s):
        return (rng.normal(size=s) * scale).astype(dtype)
    return {k: ({kk: draw(ss) for kk, ss in v.items()}
                if isinstance(v, dict) else draw(v))
            for k, v in shapes.items()}


def to_torch(tree, dtype=None):
    if isinstance(tree, dict):
        return {k: to_torch(v, dtype) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree))
    return t.to(dtype) if dtype is not None else t


@settings(deadline=None, max_examples=12)
@given(seed=st.integers(0, 2**16), gscale=st.sampled_from([1e-3, 1.0, 50.0]))
def test_global_norm_matches_repro(seed, gscale):
    tree = random_tree(np.random.default_rng(seed), scale=gscale)
    got = float(TT.optimizer.global_norm(to_torch(tree)))
    want = float(JT.optimizer.global_norm(jax.tree.map(jnp.asarray, tree)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


ADAM_CASES = [("float32", "float32"), ("float32", "bfloat16"),
              ("bfloat16", "bfloat16")]


@pytest.mark.parametrize("param_dtype,moment_dtype", ADAM_CASES)
@settings(deadline=None, max_examples=8)
@given(seed=st.integers(0, 2**16), gscale=st.sampled_from([1e-2, 1.0, 30.0]),
       clip=st.sampled_from([0.0, 1.0]))
def test_adamw_update_matches_repro(param_dtype, moment_dtype, seed, gscale,
                                    clip):
    """Three updates from the same params and gradients; bf16 leaves
    bit-equal, f32 leaves within rtol 1e-5."""
    rng = np.random.default_rng(seed)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip,
              m_dtype=moment_dtype, v_dtype=moment_dtype)
    oc, joc = TT.OptConfig(**kw), JT.OptConfig(**kw)
    tdt = getattr(torch, param_dtype)
    params = random_tree(rng)
    tp = to_torch(params, tdt)
    jp = jax.tree.map(lambda x: jnp.asarray(x, param_dtype), params)
    tstate, jstate = TT.adamw_init(tp, oc), JT.adamw_init(jp, joc)
    for _ in range(3):
        grads = random_tree(rng, scale=gscale)
        tp, tstate, tm = TT.adamw_update(to_torch(grads, tdt), tstate, tp,
                                         oc)
        jp, jstate, jm = JT.adamw_update(
            jax.tree.map(lambda x: jnp.asarray(x, param_dtype), grads),
            jstate, jp, joc)
    for got, want, dt in ((tp, jp, param_dtype),
                          (tstate["m"], jstate["m"], moment_dtype),
                          (tstate["v"], jstate["v"], moment_dtype)):
        g, w = leaves_np(got), jax_leaves_np(want)
        for path in w:
            if dt == "bfloat16":
                np.testing.assert_array_equal(g[path], w[path])
            else:
                np.testing.assert_allclose(g[path], w[path], rtol=1e-5,
                                           atol=1e-7)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)


def test_adamw_matches_numpy_reference():
    """The reference's own numpy check, on the port."""
    oc = TT.OptConfig(lr=1e-2, warmup_steps=0, total_steps=100,
                      min_lr_frac=1.0, weight_decay=0.1, clip_norm=0.0,
                      m_dtype="float32", v_dtype="float32")
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    gw = rng.normal(size=(4, 3)).astype(np.float32)
    p = {"w": torch.from_numpy(p0.copy())}
    new_p, state, _ = TT.adamw_update({"w": torch.from_numpy(gw)},
                                      TT.adamw_init(p, oc), p, oc)
    m, v = 0.1 * gw, 0.05 * gw * gw
    want = p0 - 1e-2 * ((m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.95)) + oc.eps)
                        + 0.1 * p0)
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)
    assert new_p["w"] is p["w"] and int(state["step"]) == 1   # in place


def test_clipping_bounds_update_norm():
    oc = TT.OptConfig(clip_norm=1e-3, weight_decay=0.0, warmup_steps=0,
                      min_lr_frac=1.0, lr=1.0, m_dtype="float32",
                      v_dtype="float32")
    p = {"w": torch.ones((8, 8))}
    g = {"w": torch.full((8, 8), 100.0)}
    state = TT.adamw_init(p, oc)
    _, state, metrics = TT.adamw_update(g, state, p, oc)
    assert float(metrics["grad_norm"]) == pytest.approx(800.0)
    # the clipped gradient is g * 1e-3 / 800 everywhere; Adam's first
    # step moves every element by lr * g / |g| = 1
    np.testing.assert_allclose(state["m"]["w"].numpy(),
                               0.1 * 100.0 * 1e-3 / 800.0, rtol=1e-5)
    np.testing.assert_allclose(p["w"].numpy(), 0.0, atol=1e-4)


# ------------------------------------------------------------------ #
# Gradients of loss_fn: every smoke config in float32
# ------------------------------------------------------------------ #
def port_grads(tp, tc, batch):
    pairs = list(tree_leaves(tp))
    live = [p.detach().requires_grad_() for _, p in pairs]
    tree = T.builder.tree_from_leaves(
        (path, x) for (path, _), x in zip(pairs, live))
    loss, _ = T.loss_fn(tree, tc, torch_batch(batch))
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    return loss, {path: g for (path, _), g in zip(pairs, grads)}


@pytest.mark.parametrize("name", SMOKES)
def test_loss_grads_match_repro(name):
    jc, tc = configs(name)
    batch = make_batch(jc)

    def ref(key, b):
        p = J.init_model(jc, key)[0]
        (loss, _), g = jax.value_and_grad(J.loss_fn, has_aux=True)(p, jc, b)
        return p, loss, g
    jp, jloss, jg = run_jax(ref, jax.random.PRNGKey(2),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    tp = lm_params_from_jax(jp, tc, "cpu")
    loss, grads = port_grads(tp, tc, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    want = jax_leaves_np(jg)
    assert set(grads) == set(want)
    for path, g in grads.items():
        g = g.numpy()
        assert np.isfinite(g).all(), path
        np.testing.assert_allclose(
            g, want[path], rtol=1e-4,
            atol=1e-5 * float(np.abs(want[path]).max()),
            err_msg="/".join(path))
    if name.startswith(("llama4", "deepseek")):
        # the router's gradient flows through the kept slots' weights
        routers = [p for p in grads if p[-1] == "router"]
        assert routers and all(grads[p].abs().sum() > 0 for p in routers)


def test_moe_drop_rows_get_no_gradient():
    """llama4-smoke (top-1 over 4 experts) at capacity factor 0.1: the
    capacity is 4, so 24 tokens a sequence over 16 slots drop at least 8
    routes a sequence. Dropped routes feed no expert: the gradients stay
    equal to repro's and finite, and the leaves with an exactly zero
    gradient are the same in both packages."""
    jc, tc = configs("llama4-scout-17b-a16e-smoke", moe_capacity_factor=0.1)
    batch = make_batch(jc, S=24)

    def ref(key, b):
        p = J.init_model(jc, key)[0]
        return p, jax.grad(lambda q: J.loss_fn(q, jc, b)[0])(p)
    jp, jg = run_jax(ref, jax.random.PRNGKey(3),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    _, grads = port_grads(lm_params_from_jax(jp, tc, "cpu"), tc, batch)
    want = jax_leaves_np(jg)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], rtol=1e-4,
                                   atol=1e-5 * float(np.abs(
                                       want[path]).max()) + 1e-12)
    zero_t = {p for p, g in grads.items() if not g.abs().any()}
    zero_j = {p for p, w in want.items() if not np.abs(w).any()}
    assert zero_t == zero_j


# ------------------------------------------------------------------ #
# remat changes no value
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", ["qwen3-0.6b-smoke", "whisper-tiny-smoke",
                                  "zamba2-1.2b-smoke"])
def test_remat_policies_give_identical_grads(name):
    base = torch_config(name).replace(param_dtype="float32",
                                      compute_dtype="float32")
    params, _ = T.init_model(base, torch.Generator("cpu").manual_seed(1),
                             device="cpu")
    batch = make_batch(base)
    out = {}
    for remat in ("none", "full", "dots"):
        loss, grads = port_grads(params, base.replace(remat=remat), batch)
        out[remat] = (loss, grads)
    loss0, g0 = out["none"]
    for remat in ("full", "dots"):
        loss, g = out[remat]
        assert torch.equal(loss, loss0)
        assert all(torch.equal(g[p], g0[p]) for p in g0), remat


def test_remat_policies_recompute_what_they_say():
    """Ops the backward runs, per policy, on a 2-layer stacked stage:
    "full" recomputes each layer's matmuls (``mm``) and batched
    attention products (``bmm``); "dots" keeps the matmuls without batch
    dims and recomputes the ``bmm``; "none" recomputes nothing."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    cfg = torch_config("qwen3-0.6b-smoke")
    params, _ = T.init_model(cfg, torch.Generator("cpu").manual_seed(1),
                             device="cpu")
    batch = torch_batch(make_batch(cfg, B=2, S=32))
    ops = {}
    for remat in ("none", "full", "dots"):
        live = {p: x.detach().requires_grad_()
                for p, x in tree_leaves(params)}
        loss, _ = T.loss_fn(T.builder.tree_from_leaves(live.items()),
                            cfg.replace(remat=remat), batch)
        with Count() as count:
            torch.autograd.grad(loss, list(live.values()))
        ops[remat] = count.ops
    mm = {r: c["aten.mm"] for r, c in ops.items()}
    bmm = {r: c["aten.bmm"] for r, c in ops.items()}
    assert mm["none"] == mm["dots"] < mm["full"]
    assert bmm["none"] < bmm["dots"] == bmm["full"]


def test_language_model_can_hold_trainable_parameters():
    cfg = torch_config("qwen3-0.6b-smoke")
    params, _ = T.init_model(cfg, torch.Generator("cpu").manual_seed(0),
                             device="cpu")
    frozen = T.LanguageModel(cfg, params)
    model = T.LanguageModel(cfg, params, trainable=True)
    assert not any(p.requires_grad for p in frozen.parameters())
    assert all(p.requires_grad for p in model.parameters())
    batch = torch_batch(make_batch(cfg))
    loss, _ = T.loss_fn(model.tree(), cfg, batch)
    loss.backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


# ------------------------------------------------------------------ #
# Data pipeline
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("name", ["qwen3-0.6b-smoke", "internvl2-26b-smoke",
                                  "whisper-tiny-smoke"])
@settings(deadline=None, max_examples=6)
@given(seed=st.integers(0, 1000), step=st.integers(0, 10_000),
       procs=st.sampled_from([1, 2, 4]))
def test_batch_at_bit_equal_to_repro(name, seed, step, procs):
    for pi in range(procs):
        got = SyntheticLMData(torch_config(name),
                              DataConfig(16, 8, seed, procs, pi))
        want = JData(jax_config(name), JDataConfig(16, 8, seed, procs, pi))
        g, w = got.batch_at(step), want.batch_at(step)
        assert set(g) == set(w)
        assert ("frontend" in g) == (torch_config(name).frontend != "none")
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape
            np.testing.assert_array_equal(g[k], w[k])
        assert g["tokens"].shape[0] == 8 // procs
        np.testing.assert_array_equal(g["tokens"][:, 1:],
                                      g["labels"][:, :-1])


def test_data_config_rejects_an_uneven_split():
    with pytest.raises(ValueError):
        SyntheticLMData(torch_config("qwen3-0.6b-smoke"),
                        DataConfig(16, 6, num_processes=4))
