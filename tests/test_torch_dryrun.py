"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``).

Each world runs in its own subprocess and is destroyed there: the port's
on the ``fake`` backend, the reference's over host devices (its module
sets ``--xla_force_host_platform_device_count=512`` before it imports
JAX; the mesh takes the first four). On a ``(2, 2)``
mesh the smoke cell's record must equal the reference's in ``params``,
``params_active`` and ``model_flops``, and its per-device dot flops must
be within 10 % of the reference's ``scan_aware_totals`` flops (measured
gap: +0.49 % for ``qwen3-0.6b-smoke`` x ``train_4k`` — both count every
product once on its local shard, the recompute of ``remat`` included).
Collective bytes are printed side by side but not held: the two
partitioners (XLA's and DTensor's) choose different collectives."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import ASSIGNED, SHAPES  # noqa: E402
from repro.configs import cell_supported as j_supported  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402

from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import cell_supported, get_config  # noqa: E402
from repro_torch.configs.rlc_paper import RLC_CELLS  # noqa: E402

ARCH, SHAPE = "qwen3-0.6b-smoke", "train_4k"


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [p for p in sys.path if p]), **kw)


def _run(code, **env):
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=_env(**env), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


_PORT = """
    import json
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.configs.rlc_paper import RLC_CELLS
    out = {}
    with D.fake_world(4):
        mesh = make_host_mesh(model=2, device="cuda")
        out["cell"] = D.lower_cell("%s", "%s", mesh)
    with D.fake_world(256):
        mesh = make_production_mesh(device="cuda")
        out["rlc"] = {n: D.lower_rlc_cell(n, mesh) for n in RLC_CELLS}
    print(json.dumps(out))
""" % (ARCH, SHAPE)

_REF = """
    import json
    import numpy as np
    from repro.launch import dryrun as D
    import jax
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    print(json.dumps(D.lower_cell("%s", "%s", mesh)))
""" % (ARCH, SHAPE)


@pytest.fixture(scope="module")
def records():
    port = _run(_PORT)
    ref = _run(_REF, JAX_PLATFORMS="cpu")
    return port, ref


def test_cell_equals_repro_on_a_two_by_two_mesh(records):
    port, ref = records
    got = port["cell"]
    assert got["mesh"] == {"data": 2, "model": 2} and got["chips"] == 4
    for key in ("params", "params_active", "model_flops"):
        assert got[key] == ref[key], key
    ours, theirs = got["cost"]["flops_per_dev"], ref["cost"]["flops_per_dev"]
    assert abs(ours - theirs) <= 0.10 * theirs, (ours, theirs)
    print(f"\n{ARCH} x {SHAPE} on (2, 2): flops/dev port {ours:.6e}, "
          f"repro {theirs:.6e} (gap {ours / theirs - 1:+.2%})")
    for kind in sorted(set(got["collectives"]) | set(ref["collectives"])):
        print(f"  {kind:>18}: port {got['collectives'].get(kind, 0):>14} "
              f"repro {ref['collectives'].get(kind, 0):>14}")
    assert got["useful_flops_ratio"] == pytest.approx(
        got["model_flops"] / got["cost"]["hlo_flops_total"])
    # keys: the reference's, less those with no meaning here
    assert set(got) == set(ref)
    assert set(got["memory"]) == set(ref["memory"]) - {"alias_bytes_per_dev"}
    assert set(got["cost"]) == set(ref["cost"]) - {"xla_flops_per_dev",
                                                   "xla_bytes_per_dev"}
    assert set(got["roofline"]) == set(ref["roofline"])
    mem = got["memory"]
    assert mem["peak_bytes_per_dev"] == (mem["argument_bytes_per_dev"]
                                         + mem["output_bytes_per_dev"]
                                         + mem["temp_bytes_per_dev"])


def test_rlc_cells_end_ok_on_the_pod_mesh(records):
    rlc = records[0]["rlc"]
    assert set(rlc) == set(RLC_CELLS)
    n = RLC_CELLS["rlc-build-64k"].num_vertices
    build = rlc["rlc-build-64k"]
    # rows over data (16), columns over model (16): every rank multiplies
    # its (n/16, n) row block by the gathered matrix's column block
    assert build["cost"]["flops_per_dev"] == 2 * n ** 3 / 256
    assert build["chips"] == 256 and build["collectives"]["total"] > 0
    for name in ("rlc-query-1m", "rlc-query-1m-sorted"):
        rec = rlc[name]
        assert rec["skipped"] is False and rec["roofline"]["memory_s"] > 0
        # rows replicated, queries split: no collective at all
        assert rec["collectives"]["total"] == 0


def test_cell_supported_matches_repro():
    assert list(T_SHAPES) == list(SHAPES)
    for arch in ASSIGNED:
        for shape in SHAPES:
            assert cell_supported(get_config(arch), T_SHAPES[shape]) == \
                j_supported(jax_config(arch), SHAPES[shape]), (arch, shape)


def test_cli_skips_what_repro_skips(tmp_path):
    """A cell the assignment skips ends ``skipped`` with the reference's
    reason, through the CLI, exit code 0."""
    arch = next(a for a in ASSIGNED
                if not cell_supported(get_config(a), T_SHAPES["long_500k"])[0])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "long_500k", "--out", str(tmp_path)], env=_env(),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"{arch}__long_500k__pod__mb8: skipped" in out.stdout
    rec = json.loads((tmp_path / f"{arch}__long_500k__pod__mb8.json")
                     .read_text())
    assert rec["status"] == "skipped"
    assert rec["reason"] == j_supported(jax_config(arch),
                                        SHAPES["long_500k"])[1]


def test_dryrun_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.launch.dryrun, repro_torch.roofline; "
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules if sys.modules[m] is not None)")
    subprocess.run([sys.executable, "-c", code], check=True, env=_env())
