"""The eight example twins (``repro_torch.examples``) against the JAX
package's ``examples/`` scripts, on the CPU (``device="cpu"``, seeded).

* Twins 1-5 (``online_service``, ``quickstart``, ``fraud_detection``,
  ``delta_updates``, ``sharded_service``): the reference script's
  ``main`` is loaded from its file and run here with its report captured
  and its results recorded (the service's ``query``/``query_batch``/
  ``apply_delta`` and ``DeviceIndex.query_batch`` wrapped); each twin's
  returned answers must be the same booleans, its entry counts, pruning
  counters and delta accounting equal. The two reports must be the same
  lines once these are left out: timing lines (latency, q/s, ms), the
  device a layout names, the lines of counts that depend on how
  arrivals fell into batches (a deadline flush after 2 ms: cache,
  scheduler, router and fan-out counts) and the port's swap line (it
  publishes a swap at once where the reference rolls it: ROADMAP C fact
  6).
* Twin 6 (``distributed_index``): the reference in a subprocess on 8
  forced host devices (``make_rlc_mesh(data=4, pod=2)``), the twin on a
  one-rank world here and on 4 spawned gloo ranks (``pod=2, data=2``):
  the same entries and answers, all three.
* Twin 7 (``serve_lm``): the tokens the reference prints, generated by
  the twin from ``repro``'s weights (``lm_params_from_jax``).
* Twin 8 (``train_lm``) at ``qwen3-0.6b-smoke`` for 10 steps, a
  checkpoint every 5 and a failure after step 5 computes: one restart,
  a falling loss, and the replayed history equal, bit for bit, to the
  port's own uninterrupted run.
* Every twin raises when asked for ``cuda`` without a card, and imports
  without ``jax`` or ``repro``.
"""
import contextlib
import importlib
import importlib.util
import io
import multiprocessing as mp
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

ROOT = Path(__file__).resolve().parents[1]
TWINS = ["online_service", "quickstart", "fraud_detection", "delta_updates",
         "sharded_service", "distributed_index", "serve_lm", "train_lm"]
# report lines left out of the comparison (see the module docstring)
VOLATILE = re.compile(r"q/s|^cache:|^scheduler:|^router:|^fan-out:|"
                      r"^graph updated;|^\s+fallbacks:")
TIMING = re.compile(r"\d+(\.\d+)? ?ms\b")


def reference(name):
    """The reference script's module, loaded from ``examples/``."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def twin(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def captured(fn, *args, **kwargs):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


def report(text):
    """The report's lines without the volatile ones, times and device
    names blanked."""
    return [TIMING.sub("?ms", re.sub(r"device=\S+", "device=?", line))
            for line in text.splitlines() if not VOLATILE.search(line)]


def recorder(monkeypatch, cls, name):
    """Wrap ``cls.name`` to record every return value."""
    calls = []
    orig = getattr(cls, name)

    def wrapped(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(cls, name, wrapped)
    return calls


def flat(batches):
    return [bool(a) for b in batches for a in b]


@pytest.fixture
def jax_ref():
    return pytest.importorskip("jax")


# ------------------------------------------------------------------ #
# Twins 1-5
# ------------------------------------------------------------------ #
def test_online_service(jax_ref, monkeypatch):
    from repro.service import RLCService
    singles = recorder(monkeypatch, RLCService, "query")
    batches = recorder(monkeypatch, RLCService, "query_batch")
    _, want = captured(reference("online_service").main)
    got, text = captured(twin("online_service").main, device="cpu")
    assert report(text) == report(want)
    # the four textual queries (each a batch of one in the reference),
    # then the rejected one, never answered, then the stream
    assert got["singles"] == [bool(a) for a in singles]
    assert got["answers"] == flat(batches)[-1500:]
    assert len(flat(batches)) == 1504
    assert got["wrong"] == 0 and got["rejected"]
    assert f"index: {got['entries']} entries" in want
    n_true = sum(got["answers"])
    assert (f"answers: {n_true} true / {1500 - n_true} false, 0 oracle "
            f"mismatches") in want


def test_quickstart(jax_ref):
    _, want = captured(reference("quickstart").main)
    got, text = captured(twin("quickstart").main, device="cpu")
    assert text.splitlines() == want.splitlines()   # nothing is volatile
    pr1, pr2, pr3 = got["pruned"]
    assert f"PR1={pr1} PR2={pr2} PR3 cuts={pr3}" in want
    assert f"{got['entries']} entries ({got['size_bytes']} bytes)" in want
    assert got["answers"] == [True, True, False]
    assert got["table"] == [line for line in want.splitlines()
                            if re.match(r"  v\d+: L_in", line)]


def test_fraud_detection(jax_ref, monkeypatch):
    from repro.core.device_index import DeviceIndex
    batches = recorder(monkeypatch, DeviceIndex, "query_batch")
    _, want = captured(reference("fraud_detection").main)
    got, text = captured(twin("fraud_detection").main, device="cpu")
    assert report(text) == report(want)
    assert (got["q1"], got["q2"]) == (True, False)
    assert len(batches) == 1
    assert got["answers"] == [bool(a) for a in np.asarray(batches[0])]
    assert got["hits"] == 128


def test_delta_updates(jax_ref, monkeypatch):
    from repro.service import RLCService
    batches = recorder(monkeypatch, RLCService, "query_batch")
    deltas = recorder(monkeypatch, RLCService, "apply_delta")
    _, want = captured(reference("delta_updates").main)
    got, text = captured(twin("delta_updates").main, device="cpu")
    assert report(text) == report(want)
    assert len(deltas) == len(got["deltas"]) == 5
    for mine, theirs in zip(got["deltas"], deltas):
        d = theirs["delta"]
        for key in ("phases_replayed", "phases_total", "phases_rerun",
                    "causes", "dirty_rows", "fallback"):
            assert mine[key] == d[key], key
        assert mine["cache_evicted"] == theirs["cache_evicted"]
    assert got["answers"] == [[bool(a) for a in b] for b in batches[1:]]
    assert f"index: {got['entries']} entries" in want
    assert (f"done: {got['queries_served']} queries served, "
            f"{got['deltas_applied']} deltas applied") in want
    assert f"invalidations {got['invalidations']}" in want


def test_sharded_service(jax_ref, monkeypatch):
    from repro.service import ShardedRLCService
    batches = recorder(monkeypatch, ShardedRLCService, "query_batch")
    _, want = captured(reference("sharded_service").main)
    got, text = captured(twin("sharded_service").main, device="cpu")
    assert report(text) == report(want)
    assert f"plan: {got['plan']}" in want
    assert got["answers"] == flat(batches[:-1])
    assert got["answers2"] == flat(batches[-1:])
    assert got["wrong"] == got["wrong2"] == 0
    assert got["remote_joins_numpy"] == 0 and got["generation"] == 1
    assert (f"post-swap: 0 oracle mismatches, {got['changed']}/300 answers "
            f"changed") in want


# ------------------------------------------------------------------ #
# Twin 6: the mesh
# ------------------------------------------------------------------ #
_REFERENCE_MESH = """
import os, pickle, sys
sys.path.insert(0, {src!r})
import importlib.util
spec = importlib.util.spec_from_file_location("ref", {path!r})
ref = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ref)
seen = {{}}
build, query = ref.distributed_build, ref.distributed_query_batch
def record_build(*a, **k):
    idx, eng = build(*a, **k)
    seen["entries"] = sorted(
        (v, side, h, tuple(mr)) for v in range(idx.num_vertices)
        for side, rows in (("in", idx.l_in[v]), ("out", idx.l_out[v]))
        for h, mrs in rows.items() for mr in mrs)
    seen["num_mrs"] = len(eng.mrs)
    return idx, eng
def record_query(*a, **k):
    ans = query(*a, **k)
    seen["answers"] = [bool(x) for x in ans]
    return ans
ref.distributed_build, ref.distributed_query_batch = record_build, record_query
ref.main()
with open({out!r}, "wb") as f:
    pickle.dump(seen, f)
"""


def _mesh_rank(rank, world, store_path, out_path):
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path,
                                                             world),
                                rank=rank, world_size=world)
        with contextlib.redirect_stdout(io.StringIO()):
            got = twin("distributed_index").main(device="cpu")
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(got, f)
        dist.destroy_process_group()
    except BaseException:
        with open(f"{out_path}.{rank}.err", "w") as f:
            f.write(traceback.format_exc())
        raise


def four_ranks(tmp_path):
    out, world = str(tmp_path / "rank0.pkl"), 4
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_mesh_rank, args=(
        r, world, str(tmp_path / "store"), out)) for r in range(world)]
    for p in procs:
        p.start()
    errs = [f"{out}.{r}.err" for r in range(world)]
    try:
        end = time.monotonic() + 240
        while any(p.is_alive() for p in procs) and time.monotonic() < end \
                and not any(map(os.path.exists, errs)):
            time.sleep(0.2)
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
    assert all(p.exitcode == 0 for p in procs)
    with open(out, "rb") as f:
        return pickle.load(f)


def test_distributed_index(jax_ref, tmp_path):
    out = tmp_path / "ref.pkl"
    code = _REFERENCE_MESH.format(
        src=str(ROOT / "src"), path=str(ROOT / "examples" /
                                        "distributed_index.py"),
        out=str(out))
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=(
        "--xla_force_host_platform_device_count=8"))
    text = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                          capture_output=True, text=True,
                          timeout=600).stdout
    assert "mesh: {'pod': 2, 'data': 4}" in text
    with open(out, "rb") as f:
        want = pickle.load(f)
    if dist.is_initialized():
        dist.destroy_process_group()
    one, text = captured(twin("distributed_index").main, device="cpu")
    assert not dist.is_initialized()       # the world it started is gone
    assert "mesh: {'pod': 1, 'data': 1}" in text
    four = four_ranks(tmp_path)
    assert (one["world"], four["world"]) == (1, 4)
    assert four["mesh"] == (2, 2)
    for got in (one, four):
        assert got["entries"] == want["entries"]
        assert got["num_mrs"] == want["num_mrs"]
        assert got["answers"] == want["answers"]
    assert f"{len(want['entries'])} entries" in text


# ------------------------------------------------------------------ #
# Twins 7-8: the LM substrate
# ------------------------------------------------------------------ #
def tokens_of(text):
    return [line.split("=>")[1].strip() for line in text.splitlines()
            if line.strip().startswith("req")]


def test_serve_lm(jax_ref):
    from repro.configs import get_config as j_config
    from repro.models import init_model as j_init

    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    _, want = captured(reference("serve_lm").main)
    # the reference's own weights: init_model(cfg, PRNGKey(0)), as it draws
    params, _ = j_init(j_config("qwen3-0.6b-smoke"), jax_ref.random.PRNGKey(0))
    ours = lm_params_from_jax(jax_ref.tree.map(np.asarray, params),
                              get_config("qwen3-0.6b-smoke"), "cpu")
    got, text = captured(twin("serve_lm").main, device="cpu", params=ours)
    assert got["tokens"].shape == (4, 16)
    assert tokens_of(text) == tokens_of(want)
    assert text.splitlines()[0] == want.splitlines()[0]


def test_train_lm_survives_its_failure(tmp_path, monkeypatch):
    from repro_torch.launch.train import run
    # torch's first activation checkpoint imports torch._dynamo, which
    # makes its cache directory under the temporary directory; import it
    # first so that directory does not land in ``tmp_path``
    import torch._dynamo  # noqa: F401
    train_lm = twin("train_lm")
    arch, steps = "qwen3-0.6b-smoke", 10
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got, text = captured(train_lm.main, device="cpu", steps=steps, batch=4,
                         seq=16, arch=arch, ckpt_every=5)
    assert os.listdir(tmp_path) == []      # its checkpoints are removed
    assert got["restarts"] == 1 and got["steps_run"] == steps
    history = got["history"]
    assert len(history) == steps + 1       # step 5 computed twice
    assert history[-1] < history[0]
    _, want, _ = run(arch, steps=steps, batch=4, seq=16, lr=6e-4,
                     log_every=1000, device="cpu")
    assert history[:5] + history[6:] == want
    assert history[5] == history[6]
    assert "restarts survived: 1" in text
    assert train_lm.CFG_100M.num_layers == 12
    assert train_lm.CFG_100M.d_model == 768


def test_train_lm_registers_the_reference_config(jax_ref):
    from repro.configs import get_config as j_config
    from repro.models import count_params as j_count
    from repro.models import init_model as j_init

    from repro_torch.configs import get_config
    from repro_torch.models import count_params, init_model
    reference("train_lm")             # registers examples-lm-100m in repro
    twin("train_lm")
    want = j_config("examples-lm-100m")
    got = get_config("examples-lm-100m")
    for field in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "head_dim", "d_ff", "vocab_size", "qk_norm",
                  "vocab_pad_multiple", "param_dtype", "compute_dtype"):
        assert getattr(got, field) == getattr(want, field), field
    assert count_params(init_model(got, abstract=True)[0]) == \
        j_count(j_init(want, abstract=True)[0])


# ------------------------------------------------------------------ #
# Every twin
# ------------------------------------------------------------------ #
@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where no card is present")
@pytest.mark.parametrize("name", TWINS)
def test_twin_refuses_cuda_without_a_card(name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin(name).main(device="cuda")


def test_twins_import_without_jax():
    modules = ", ".join(f"repro_torch.examples.{n}" for n in TWINS)
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            f"import {modules}; "
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules if sys.modules[m] is not None), "
            "'imported the JAX package'")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env=dict(os.environ, PYTHONPATH=os.pathsep.join(
                       [p for p in sys.path if p])))
