"""Port vs reference: the model substrate (``configs``, ``models``).

Every assigned architecture's smoke config runs through both packages
with the same weights: ``repro``'s ``init_model`` draws them, and
``convert.lm_params_from_jax`` carries them into the port. ``forward``
logits and aux and ``loss_fn`` must agree within rtol = atol = 1e-4 in
float32 (2e-2 for the bfloat16 case of ``qwen3-0.6b-smoke``). The
parameter trees' paths, shapes and logical axes must be equal, and the
full configs' parameter counts on the ``meta`` device equal to the
reference's abstract counts. Module by module: chunked attention, the MoE
router's slots and drops with both combines, the SSD scan and the causal
conv. The whisper encoder is causal in both packages. The port's
``configs``, ``models``, ``serve`` and ``convert`` import with JAX
blocked. Prefill, decode and ``ServeEngine`` are in
``test_torch_serve.py``.
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models as J  # noqa: E402
from repro.configs import ASSIGNED  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

import repro_torch.models as T  # noqa: E402
from repro_torch.configs import get_config as torch_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.builder import tree_leaves  # noqa: E402

SMOKES = [a + "-smoke" for a in ASSIGNED]
# (config, dtype, tolerance): every smoke in float32, qwen3 also in bf16
CASES = [(n, "float32", 1e-4) for n in SMOKES] + [
    ("qwen3-0.6b-smoke", "bfloat16", 2e-2)]
CASE_IDS = [f"{n}-{d}" for n, d, _ in CASES]


def configs(name: str, dtype: str = "float32"):
    """The same config in both packages, params and compute in ``dtype``."""
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (jax_config(name).replace(**kw),
            torch_config(name).replace(**kw))


# Each reference call is one XLA program that rounds every op to its
# dtype, as the reference evaluated op by op does and as the port does:
# by default XLA keeps excess precision between fused bfloat16 ops, which
# moves qwen3-0.6b-smoke's bf16 logits (std 8) by up to 0.3, 12 % of them
# beyond 2e-2. Optimisation level 0 keeps the compile time short.
XLA_OPTIONS = {"xla_allow_excess_precision": False,
               "xla_backend_optimization_level": 0}


def run_jax(fn, *args):
    return jax.jit(fn).lower(*args).compile(
        compiler_options=XLA_OPTIONS)(*args)


def same_weights(name: str, dtype: str = "float32", seed: int = 2):
    """(jax cfg, torch cfg, repro params, port params on the CPU)."""
    jc, tc = configs(name, dtype)
    jp = run_jax(lambda k: J.init_model(jc, k)[0], jax.random.PRNGKey(seed))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def make_batch(cfg, B=2, S=12, seed=2):
    """numpy tokens, labels (one ignored) and, where the config has a
    frontend, its frames."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    batch["labels"][0, -1] = -1
    if cfg.frontend != "none":
        batch["frontend"] = rng.normal(
            size=(B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return batch


def as_np(x):
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy() \
        if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def close(got, want, tol):
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def reference():
    """Per case: both configs, the port's weights, the batch, and repro's
    forward (logits, aux) and loss metrics, its init included in one
    program."""
    done = {}

    def get(name, dtype):
        if (name, dtype) not in done:
            jc, tc = configs(name, dtype)
            batch = make_batch(jc)

            def ref(key, b):
                p = J.init_model(jc, key)[0]
                return p, (J.forward(p, jc, b["tokens"], b.get("frontend")),
                           J.loss_fn(p, jc, b)[1])
            jp, out = run_jax(ref, jax.random.PRNGKey(2),
                              {k: jnp.asarray(v) for k, v in batch.items()})
            tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")
            done[name, dtype] = (jc, tc, tp, batch, out)
        return done[name, dtype]
    return get


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("name,dtype,tol", CASES, ids=CASE_IDS)
def test_forward_matches_repro(reference, name, dtype, tol):
    jc, tc, tp, batch, ((logits, aux), _) = reference(name, dtype)
    b = torch_batch(batch)
    got, got_aux = T.forward(tp, tc, b["tokens"], b.get("frontend"))
    assert got.shape == (*batch["tokens"].shape, tc.padded_vocab)
    assert got.dtype == tc.dtype("compute")
    close(got, logits, tol)
    close(got_aux, aux, tol)


@pytest.mark.parametrize("name,dtype,tol", CASES, ids=CASE_IDS)
def test_loss_matches_repro(reference, name, dtype, tol):
    jc, tc, tp, batch, (_, metrics) = reference(name, dtype)
    loss, got = T.loss_fn(tp, tc, torch_batch(batch))
    assert int(got["tokens"]) == int(metrics["tokens"]) == batch[
        "labels"].size - 1
    for key in ("loss", "xent", "aux"):
        close(got[key], metrics[key], tol)
    assert loss is got["loss"]


def test_language_model_module_keys(reference):
    jc, tc, tp, batch, ((logits, _), _) = reference("qwen3-0.6b-smoke",
                                                    "float32")
    model = T.LanguageModel(tc, tp)
    want = {".".join(p) for p in _jax_paths(J.init_model(jc,
                                                         abstract=True)[0])}
    assert set(model.state_dict()) == want
    assert all(not p.requires_grad for p in model.parameters())
    got, _ = model(torch.from_numpy(batch["tokens"]))
    close(got, logits, 1e-4)


def _jax_paths(tree):
    return [tuple(k.key for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("name", SMOKES)
def test_tree_paths_shapes_axes_match_repro(name):
    jc, tc = configs(name)
    jp, jaxes = J.init_model(jc, abstract=True)
    tp, taxes = T.init_model(tc, abstract=True)
    want = {tuple(k.key for k in path): (leaf.shape, leaf.dtype.name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {path: (tuple(leaf.shape), str(leaf.dtype).split(".")[1])
           for path, leaf in tree_leaves(tp)}
    assert got == want
    assert all(leaf.device.type == "meta" for _, leaf in tree_leaves(tp))
    assert taxes == jaxes
    assert T.param_bytes(tp) == J.param_bytes(jp)


@pytest.mark.parametrize("name", ASSIGNED)
def test_full_config_param_counts_match_repro(name):
    jc, tc = configs(name)
    tp, _ = T.init_model(tc, abstract=True)
    assert T.count_params(tp) == J.count_params(
        J.init_model(jax_config(name), abstract=True)[0])
    assert all(leaf.device.type == "meta" for _, leaf in tree_leaves(tp))


def test_qwen3_full_width_figures():
    """The served model's size, as the chip run logs it."""
    params, _ = T.init_model(torch_config("qwen3-0.6b"), abstract=True)
    assert T.count_params(params) == 596_180_992
    assert T.param_bytes(params) == 2 * 596_180_992
    assert params["embed"].shape == (152_064, 1024)


def test_lm_params_from_jax_checks_paths_shapes_and_keeps_bits():
    jc, tc, jp, tp = same_weights("qwen3-0.6b-smoke", "bfloat16")
    tree = jax.tree.map(np.asarray, jp)
    want = tree["stages"]["s0"]["attn"]["wq"]["w"]
    got = tp["stages"]["s0"]["attn"]["wq"]["w"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          want.view(np.int16))
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_jax(bad, tc, "cpu")
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_jax({k: v for k, v in tree.items()
                            if k != "final_norm"}, tc, "cpu")


# ------------------------------------------------------------------ #
# Modules
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("S,chunk,window", [
    (64, 16, 0), (64, 8, 0), (128, 32, 48), (64, 64, 0), (96, 16, 24)])
def test_chunked_attention_matches_repro(S, chunk, window):
    rng = np.random.default_rng(S + chunk + window)
    q, k, v = (rng.normal(size=(2, S, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = run_jax(lambda *a: jattn._attend_mha_chunked(*a, chunk, window),
                   *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tattn._attend_mha_chunked(tq, tk, tv, chunk, window)
    close(got, want, 2e-5)
    dense = tattn._attend_mha(tq, tk, tv, tattn._causal_mask(
        S, S, 0, window)[None, None])
    close(got, dense, 2e-5)


def moe_params(cfg, seed: int):
    """One MoE layer's parameters (the shapes ``init_moe`` gives), numpy
    normals from a seed."""
    rng = np.random.default_rng(seed)
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff

    def w(*shape):
        return (rng.normal(size=shape) / np.sqrt(shape[-2])).astype(
            np.float32)
    mlp = lambda d_in, d_out: {"w": w(d_in, d_out)}  # noqa: E731
    return {"router": w(d, E), "w_gate": w(E, d, f), "w_up": w(E, d, f),
            "w_down": w(E, f, d),
            "shared": {"gate": mlp(d, f), "up": mlp(d, f),
                       "down": mlp(f, d)}}


@pytest.mark.parametrize("top_k", [1, 2, 3])
@pytest.mark.parametrize("T_,E", [(16, 4), (24, 8)])
def test_topk_slots_and_drops_match_repro(T_, E, top_k):
    rng = np.random.default_rng(T_ * E + top_k)
    # skewed gates so a few experts overflow their capacity
    logits = rng.normal(size=(T_, E)) + np.linspace(0, 2, E)
    gates = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    gates = gates.astype(np.float32)
    cap = max(1, T_ * top_k // E)
    widx, wslot, ww = run_jax(
        lambda g: jmoe._topk_with_slots(g, top_k, cap), jnp.asarray(gates))
    idx, slot, w = tmoe._topk_with_slots(torch.from_numpy(gates), top_k, cap)
    assert np.array_equal(idx.numpy(), np.asarray(widx))
    assert np.array_equal(slot.numpy(), np.asarray(wslot))
    assert (slot >= cap).any()           # the case really drops
    close(w, ww, 0)


@pytest.mark.parametrize("combine", ["scatter", "gather"])
def test_apply_moe_with_drops_matches_repro(combine):
    """Capacity factor 1.0 (the smoke configs use 8.0 and drop nothing):
    experts, slots and drops equal, outputs and aux within 1e-4."""
    kw = dict(moe_capacity_factor=1.0, moe_combine=combine)
    jc = jax_config("deepseek-v3-671b-smoke").replace(**kw)
    tc = torch_config("deepseek-v3-671b-smoke").replace(**kw)
    p = moe_params(jc, seed=5)
    x = np.random.default_rng(9).normal(size=(2, 16, jc.d_model)).astype(
        np.float32)
    cap = max(4, int(16 * jc.top_k / jc.num_experts * 1.0))
    gates = jax.nn.softmax(jnp.asarray(x) @ p["router"], -1)
    want_route = run_jax(jax.vmap(
        lambda g: jmoe._topk_with_slots(g, jc.top_k, cap)), gates)
    got_route = tmoe._topk_with_slots(torch.softmax(
        torch.from_numpy(x) @ torch.from_numpy(p["router"]), -1),
        jc.top_k, cap)
    for g, r in zip(got_route[:2], want_route[:2]):
        assert np.array_equal(g.numpy(), np.asarray(r))
    assert (np.asarray(want_route[1]) >= cap).any()     # tokens drop
    want, want_aux = run_jax(lambda p, x: jmoe.apply_moe(p, x, jc),
                             jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tp = jax.tree.map(torch.from_numpy, p)
    got, got_aux = tmoe.apply_moe(tp, torch.from_numpy(x), tc)
    close(got, want, 1e-4)
    close(got_aux, want_aux, 1e-5)


@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk,G", [(32, 8, 1), (48, 16, 2), (16, 16, 1)])
def test_ssd_chunked_matches_repro(S, chunk, G, mm_dtype):
    rng = np.random.default_rng(S + chunk + G)
    b, H, P, N = 2, 4, 8, 6
    xh = rng.normal(size=(b, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,)) * 0.5).astype(np.float32)
    Bm, Cm = (rng.normal(size=(b, S, G, N)).astype(np.float32)
              for _ in range(2))
    args = (xh, dt, A, Bm, Cm)
    want_y, want_h = run_jax(lambda *a: jssm._ssd_chunked(
        *a, chunk, mm_dtype=getattr(jnp, mm_dtype)), *map(jnp.asarray, args))
    got_y, got_h = tssm._ssd_chunked(*map(torch.from_numpy, args), chunk,
                                     mm_dtype=getattr(torch, mm_dtype))
    tol = 1e-4 if mm_dtype == "float32" else 2e-2
    close(got_y, want_y, tol)
    close(got_h, want_h, tol)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 2, 9])
def test_causal_conv_matches_repro(S, with_state):
    rng = np.random.default_rng(S)
    xbc = rng.normal(size=(2, S, 10)).astype(np.float32)
    w = rng.normal(size=(4, 10)).astype(np.float32)
    bias = rng.normal(size=(10,)).astype(np.float32)
    state = rng.normal(size=(2, 3, 10)).astype(np.float32)
    args = (xbc, w, bias) + ((state,) if with_state else ())
    want = run_jax(jssm._causal_conv, *map(jnp.asarray, args))
    got = tssm._causal_conv(*map(torch.from_numpy, args))
    for g, r in zip(got, want):
        close(g, r, 1e-5)


def test_whisper_encoder_is_causal_in_both_packages():
    """The reference calls its encoder non-causal but masks it causally;
    the port computes the same: frame 0's output ignores the last
    frame."""
    jc, tc, jp, tp = same_weights("whisper-tiny-smoke")
    rng = np.random.default_rng(4)
    frames = rng.normal(size=(2, jc.frontend_len, jc.d_model)).astype(
        np.float32)
    moved = frames.copy()
    moved[:, -1] = rng.normal(size=moved[:, -1].shape)
    outs = []
    for f in (frames, moved):
        want = run_jax(lambda p, f: jlm._run_encoder(p, jc, f), jp,
                       jnp.asarray(f))
        got = tlm._run_encoder(tp, tc, torch.from_numpy(f))
        close(got, want, 1e-4)
        outs.append((as_np(got), as_np(want)))
    for i in (0, 1):   # port, reference
        assert np.abs(outs[0][i][:, 0] - outs[1][i][:, 0]).max() == 0.0
        assert np.abs(outs[0][i][:, -1] - outs[1][i][:, -1]).max() > 0.1


# ------------------------------------------------------------------ #
# Import gate
# ------------------------------------------------------------------ #
def test_model_modules_import_without_jax():
    modules = ("repro_torch.configs", "repro_torch.models",
               "repro_torch.serve", "repro_torch.convert")
    code = ("import sys; sys.modules['jax'] = None; "
            f"import {', '.join(modules)}; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), 'imported the JAX package'")
    subprocess.run([sys.executable, "-c", code], check=True)
