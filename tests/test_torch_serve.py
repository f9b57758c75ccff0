"""Port vs reference: the serving path (``prefill``, ``decode_step``,
``ServeEngine``).

For every assigned architecture's smoke config (and qwen3-0.6b-smoke in
bfloat16), ``prefill`` on S-1 tokens and ``decode_step`` on the last one
must give ``repro``'s logits and caches within rtol = atol = 1e-4 in
float32 (2e-2 in bfloat16), with ``repro``'s weights carried over by
``convert.lm_params_from_jax``; the port writes the cache in place.
``ServeEngine.generate`` must equal ``repro``'s token for token on the
three configs and seeds of ``tests/test_serve.py``, and equal the port's
own greedy rollout by full forwards on every smoke config, the frontend
ones included. Where ``repro`` clamps a cache write past ``max_len`` and
returns tokens anyway, the port raises ``ValueError``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models as J  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402

import repro_torch.models as T  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models.builder import tree_map  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from test_torch_models import (CASE_IDS, CASES, SMOKES, close,  # noqa: E402
                               configs, make_batch, run_jax)

SERVED = ["qwen3-0.6b-smoke", "mamba2-2.7b-smoke", "zamba2-1.2b-smoke"]


def n_prefix(cfg) -> int:
    return (cfg.frontend_len
            if cfg.frontend != "none" and not cfg.encoder_layers else 0)


def flat(tree, prefix=()):
    """Leaves of a cache tree (dicts and (k, v) tuples) by path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, prefix + (i,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name,dtype,tol", CASES, ids=CASE_IDS)
def test_prefill_then_decode_match_repro(name, dtype, tol):
    jc, tc = configs(name, dtype)
    batch = make_batch(jc)
    B, S = batch["tokens"].shape
    fe = batch.get("frontend")
    max_len = S + n_prefix(jc) + 4
    pos = S - 1 + n_prefix(jc)

    def ref(key, tokens, fe):
        p = J.init_model(jc, key)[0]
        cache, _ = J.init_cache(jc, B, max_len)
        lp, cache = J.prefill(p, jc, tokens[:, :S - 1], cache, fe)
        ld, cache = J.decode_step(p, jc, cache, tokens[:, S - 1:],
                                  jnp.int32(pos))
        return p, lp, ld, cache
    jp, want_p, want_d, want_cache = run_jax(
        ref, jax.random.PRNGKey(2), jnp.asarray(batch["tokens"]),
        None if fe is None else jnp.asarray(fe))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), tc, "cpu")

    tokens = torch.from_numpy(batch["tokens"])
    tfe = None if fe is None else torch.from_numpy(fe)
    cache, _ = T.init_cache(tc, B, max_len, device="cpu")
    got_p, same = T.prefill(tp, tc, tokens[:, :S - 1], cache, tfe)
    assert same is cache
    close(got_p, want_p, tol)
    got_d, same = T.decode_step(tp, tc, cache, tokens[:, S - 1:], pos)
    assert same is cache
    close(got_d, want_d, tol)
    got, want = flat(cache), flat(want_cache)
    assert got.keys() == want.keys()
    for path in want:
        assert tuple(got[path].shape) == want[path].shape, path
        close(got[path], want[path], tol)


@pytest.fixture(scope="module")
def served():
    """Per config: repro's params at ``tests/test_serve.py``'s key, and
    the port's copy of them on the CPU."""
    done = {}

    def get(name):
        if name not in done:
            jc, tc = configs(name)
            jp = run_jax(lambda k: J.init_model(jc, k)[0],
                         jax.random.PRNGKey(3))
            done[name] = (jc, tc, jp, lm_params_from_jax(
                jax.tree.map(np.asarray, jp), tc, "cpu"))
        return done[name]
    return get


def prompts(cfg, B=2, S0=8):
    rng = np.random.default_rng(0)
    return rng.integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)


@pytest.mark.parametrize("name", SERVED)
def test_generate_matches_repro(served, name):
    jc, tc, jp, tp = served(name)
    B, S0, steps = 2, 8, 6
    p = prompts(jc, B, S0)
    want = JaxServeEngine(jc, jp, max_len=S0 + steps + 2,
                          batch_slots=B).generate(p, steps=steps)
    got = ServeEngine(tc, tp, max_len=S0 + steps + 2, batch_slots=B,
                      device="cpu").generate(p, steps=steps)
    assert got.dtype == np.int32 and got.shape == (B, steps)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", SMOKES)
def test_generate_matches_forward_rollout(name):
    """Every block kind and frontend through the engine on the CPU, with
    the port's own seeded weights: generate equals the greedy rollout by
    repeated full forwards."""
    _, tc = configs(name)
    params, _ = T.init_model(tc, torch.Generator("cpu").manual_seed(7),
                             device="cpu")
    B, S0, steps = 2, 8, 6
    batch = make_batch(tc, B=B, S=S0, seed=11)
    fe = batch.get("frontend")
    got = ServeEngine(tc, params, max_len=S0 + n_prefix(tc) + steps,
                      batch_slots=B, device="cpu").generate(
        batch["tokens"], steps, frontend=fe)
    toks = torch.from_numpy(batch["tokens"]).long()
    tfe = None if fe is None else torch.from_numpy(fe)
    want = []
    for _ in range(steps):
        logits, _ = T.forward(params, tc, toks, tfe)
        nxt = torch.argmax(logits[:, -1:, :tc.vocab_size], -1)
        want.append(nxt)
        toks = torch.cat([toks, nxt], dim=1)
    np.testing.assert_array_equal(got, torch.cat(want, 1).numpy())


def test_generate_past_max_len_raises_where_repro_clamps(served):
    """Reference fact: ``lax.dynamic_update_slice`` clamps the cache
    write, so ``repro`` returns 6 tokens for ``max_len=10, S0=8,
    steps=6`` after overwriting the last slot; the port refuses."""
    jc, tc, jp, tp = served("qwen3-0.6b-smoke")
    p = prompts(jc)
    assert JaxServeEngine(jc, jp, max_len=10, batch_slots=2).generate(
        p, steps=6).shape == (2, 6)
    engine = ServeEngine(tc, tp, max_len=10, batch_slots=2, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        engine.generate(p, steps=6)
    assert engine.generate(p, steps=2).shape == (2, 2)   # 8 + 2 fits


@pytest.mark.parametrize("name", ["qwen3-0.6b-smoke",
                                  "deepseek-v3-671b-smoke"])
def test_cache_writes_past_the_end_raise(name):
    _, tc = configs(name)
    params, _ = T.init_model(tc, torch.Generator("cpu").manual_seed(1),
                             device="cpu")
    tokens = torch.zeros((2, 6), dtype=torch.long)
    cache, _ = T.init_cache(tc, 2, 5, device="cpu")
    with pytest.raises(ValueError, match="prefill"):
        T.prefill(params, tc, tokens, cache)
    T.prefill(params, tc, tokens[:, :4], cache)
    T.decode_step(params, tc, cache, tokens[:, :1], 4)
    for pos in (5, -1):
        with pytest.raises(ValueError, match="decode"):
            T.decode_step(params, tc, cache, tokens[:, :1], pos)


def test_engine_checks_slots_and_device(served):
    jc, tc, jp, tp = served("qwen3-0.6b-smoke")
    engine = ServeEngine(tc, tp, max_len=16, batch_slots=2, device="cpu")
    with pytest.raises(ValueError, match="slots"):
        engine.generate(prompts(jc, B=3), steps=2)
    meta, _ = T.init_model(tc, abstract=True)
    with pytest.raises(ValueError, match="parameters on"):
        ServeEngine(tc, meta, max_len=16, batch_slots=2, device="cpu")


def test_generate_on_the_card_matches_the_cpu():
    """Card test: every smoke config generates the same tokens on the card
    (f32, TF32 off) as on the CPU with the same weights; a CPU generator
    cannot draw a model on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    with pytest.raises(ValueError, match="generator"):
        T.init_model(configs(SMOKES[0])[1], torch.Generator("cpu"),
                     device="cuda")
    for name in SMOKES:
        _, tc = configs(name)
        params, _ = T.init_model(tc, torch.Generator("cpu").manual_seed(7),
                                 device="cpu")
        on_card = tree_map(lambda t: t.to("cuda"), params)
        batch = make_batch(tc, B=2, S=8, seed=11)
        runs = [ServeEngine(tc, p, max_len=8 + n_prefix(tc) + 6,
                            batch_slots=2, device=dev).generate(
            batch["tokens"], 6, frontend=batch.get("frontend"))
            for p, dev in ((params, "cpu"), (on_card, "cuda"))]
        np.testing.assert_array_equal(runs[1], runs[0], err_msg=name)
