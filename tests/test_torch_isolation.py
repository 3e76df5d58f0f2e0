"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

An AST scan of every module of ``src/repro_torch`` and of ``chip_smoke.py``
finds no import of ``jax`` or ``repro``, and a fresh interpreter in which
both names are unimportable imports the port and runs a histogram on the
CPU, and the dry-run of one cell with its roofline; a spawned cluster
worker imports neither.  The port's docstring
examples run here too.
"""

import ast
import doctest
import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (
            isinstance(node, ast.Call)
            and getattr(node.func, "attr", getattr(node.func, "id", None)) == "import_module"
            and node.args
            and isinstance(node.args[0], ast.Constant)
        ):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    assert not (_imported_roots(path) & FORBIDDEN)


def test_runs_with_jax_unimportable():
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        "import numpy as np",
        "from repro_torch.core.blocked import BlockedArray, round_robin_placement",
        "from repro_torch.core.apps.histogram import histogram",
        "from repro_torch.api import SplIter",
        "pts = np.random.default_rng(0).random((64, 2)).astype(np.float32)",
        "x = BlockedArray.from_array(pts, 8, num_locations=2,",
        "                            policy=round_robin_placement, device='cpu')",
        "h, rep = histogram(x, bins=4, policy=SplIter(fusion='pallas'))",
        "ref = np.histogramdd(pts, bins=4, range=[(0, 1)] * 2)[0]",
        "assert np.array_equal(h.numpy(), ref), h",
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules if sys.modules[m]}",
        "print('ok', rep.dispatches)",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "3"]


def test_dryrun_runs_with_jax_unimportable():
    """The dry-run, its roofline and the perf script's variants run in an
    interpreter where ``jax`` and ``repro`` cannot be imported: one cell
    traced on the single-pod mesh of ``meta`` positions and analyzed."""
    code = "\n".join([
        "import sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        "import torch",
        "from repro_torch.analysis.roofline import analyze",
        "from repro_torch.launch.dryrun_lib import probe_cell, run_cell",
        "from repro_torch.launch.mesh import make_production_mesh",
        "from repro_torch.launch.perf import variant_kwargs",
        "mesh = make_production_mesh(devices=(torch.device('meta'),))",
        "kw, _ = variant_kwargs('dec')",
        "run = run_cell('mamba2-1.3b', 'decode_32k', mesh, mesh_label='single_pod', **kw)",
        "probe = probe_cell('mamba2-1.3b', 'decode_32k', mesh, mesh_label='single_pod', **kw)",
        "(row,) = analyze([run], [probe])",
        "assert 'jax' not in {m.split('.')[0] for m in sys.modules if sys.modules[m]}",
        "print(row['status'], row['devices'], row['dominant'])",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    status, devices, dominant = out.stdout.split()
    assert (status, devices) == ("OK", "256") and dominant in ("compute", "memory", "collective")


def test_spawned_cluster_worker_imports_no_jax():
    """A cluster worker is a fresh spawned interpreter: after it ran a fused
    histogram unit, its ``sys.modules`` holds neither ``jax`` nor ``repro``
    (the probe function lives in a jax-free test helper module)."""
    code = "\n".join([
        "import numpy as np",
        "import _torch_cluster_fns as fns",
        "from repro_torch.api import ClusterExecutor, SplIter",
        "from repro_torch.core.apps.histogram import histogram",
        "from repro_torch.core.blocked import BlockedArray, round_robin_placement",
        "pts = np.random.default_rng(0).random((64, 2)).astype(np.float32)",
        "x = BlockedArray.from_array(pts, 8, num_locations=2,",
        "                            policy=round_robin_placement, device='cpu')",
        "with ClusterExecutor() as ex:",
        "    h, rep = histogram(x, bins=4, policy=SplIter(fusion='pallas'), executor=ex)",
        "    roots = ex.call_workers(fns.module_roots)",
        "bad = {'jax', 'jaxlib', 'repro'}",
        "print(rep.remote_dispatches, len(roots), all('torch' in r for r in roots.values()),",
        "      sorted(bad & {m for r in roots.values() for m in r}))",
    ])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")]))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    dispatches, workers, *rest = out.stdout.split()
    assert int(dispatches) >= 2 and workers == "2" and rest == ["True", "[]"]


DOCTEST_MODULES = [
    "repro_torch._pytree",
    "repro_torch._threefry",
    "repro_torch.api.autotune",
    "repro_torch.api.chunkstore",
    "repro_torch.api.cluster_executor",
    "repro_torch.api.collection",
    "repro_torch.api.executors",
    "repro_torch.api.factory",
    "repro_torch.api.fnref",
    "repro_torch.api.kernels",
    "repro_torch.api.lowering",
    "repro_torch.api.policy",
    "repro_torch.api.shm",
    "repro_torch.api.stream_executor",
    "repro_torch.checkpoint.checkpointer",
    "repro_torch.optim.schedule",
]


@pytest.mark.parametrize("module_name", DOCTEST_MODULES)
def test_docstring_examples(module_name):
    result = doctest.testmod(
        importlib.import_module(module_name),
        optionflags=doctest.NORMALIZE_WHITESPACE | doctest.ELLIPSIS,
    )
    assert result.attempted > 0, f"{module_name} has no examples"
    assert result.failed == 0
