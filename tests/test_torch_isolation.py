"""The port imports nothing of JAX: ``surfacenetworks_tpu_torch`` and
``chip_smoke.py`` must import where jax, jaxlib, flax, optax, the JAX
package, msgpack and matplotlib cannot be imported (as on the machine with
the card, which has none of them), and no port source names them (the
config presets, the launcher, the export entry point, the native runtime's
bindings, ``preprocess``, the sampler, the spectral descriptors and the
timing tools and the distributed runtime, the Dirac partition and the
overlap check included, among them, ``torch.distributed``
allowed; ``viz.py`` imports matplotlib inside its functions only, and
imports without it), also in a rank that ``dist.mesh_setup.launch`` spawns for
``tests/_torch_dist_worker.py``.  Also:
the port's entry points refuse to run on the CPU unless asked
(``export_model`` without ``--platforms cpu`` too), and ``chip_smoke.py`` fails without a card or without the
package beside it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "surfacenetworks_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "optax", "surfacenetworks_tpu", "msgpack", "matplotlib")

_IMPORT_ALL = f"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = {BLOCKED!r}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"import of {{name}} refused")
        return None

sys.meta_path.insert(0, Refuse())
import surfacenetworks_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for want in ("config", "cli.launch", "cli.export_model", "serve", "native", "cli.preprocess", "geometry.sampling",
             "geometry.spectral", "train.timing", "dist", "dist.mesh_setup", "dist.data_parallel", "dist.edge_partition",
             "dist.graph_parallel", "dist.dirac_partition", "parallel_context", "train.loop", "viz",
             "dist.analysis"):
    assert pkg.__name__ + "." + want in names, want
for name in names:
    importlib.import_module(name)
import chip_smoke
assert hasattr(chip_smoke, "main")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
print("imported", len(names), "modules")
"""


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra)
    return env


def test_port_and_chip_smoke_import_without_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    n = int(res.stdout.split()[1])
    assert n >= 15, res.stdout


_REFUSE_SITE = f"""
import importlib.abc, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BLOCKED!r}:
            raise ModuleNotFoundError(f"import of {{name}} refused")
        return None

sys.meta_path.insert(0, Refuse())
"""


def test_dist_rank_imports_without_jax(tmp_path):
    """The worker script and a rank it spawns (a partitioned apply on a
    one-rank grid) run with jax, flax, optax and the JAX package refused in
    every process: a ``sitecustomize`` on ``PYTHONPATH`` installs the
    refusal in the spawned interpreter too."""
    import numpy as np
    import scipy.sparse as sp

    (tmp_path / "site").mkdir()
    (tmp_path / "site" / "sitecustomize.py").write_text(_REFUSE_SITE)
    L = sp.random(64, 64, density=0.05, format="csr", random_state=0, dtype=np.float32) + sp.eye(64, dtype=np.float32)
    L = L.tocsr()
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "in.npz", data=L.data, indices=L.indices, indptr=L.indptr, shape=np.asarray(L.shape),
             halo=64, k=16, x=rng.normal(size=(64, 4)).astype(np.float32), g=rng.normal(size=(64, 4)).astype(np.float32))
    spec = {"ranks": 1, "timeout": 60, "cases": [{"name": "one", "kind": "pspmm", "n_data": 1, "n_graph": 1,
                                                   "fmt": "ell", "input": str(tmp_path / "in.npz")}]}
    (tmp_path / "spec.json").write_text(__import__("json").dumps(spec))
    env = _env(PYTHONPATH=f"{tmp_path / 'site'}{os.pathsep}{REPO}")
    res = subprocess.run([sys.executable, str(REPO / "tests" / "_torch_dist_worker.py"), str(tmp_path / "spec.json"),
                          str(tmp_path)], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    y = np.load(tmp_path / "one_r0.npz")["y"]
    np.testing.assert_allclose(y, L.toarray() @ np.load(tmp_path / "in.npz")["x"], rtol=1e-5, atol=1e-5)
    probe = subprocess.run([sys.executable, "-c", "import jax"], env=env, capture_output=True, text=True, timeout=60)
    assert probe.returncode != 0 and "refused" in probe.stderr  # the refusal is live in a fresh interpreter


def test_port_sources_name_no_jax():
    # the port, and the scripts that run it on the card
    sources = sorted(PACKAGE.rglob("*.py")) + [REPO / n for n in ("chip_smoke.py", "bsr_bf16_sweep.py",
                                                                 "sddmm_bf16_check.py",
                                                                 "tests/_torch_dist_worker.py")]
    assert len(sources) >= 15
    for want in ("native/__init__.py", "cli/preprocess.py", "geometry/sampling.py", "geometry/spectral.py",
                 "train/timing.py", "dist/edge_partition.py", "dist/mesh_setup.py", "dist/dirac_partition.py",
                 "parallel_context.py", "viz.py", "dist/analysis.py"):
        assert PACKAGE / want in sources, want
    for path in sources:
        tree = ast.parse(path.read_text(), filename=str(path))
        # viz.py draws with matplotlib, imported inside its functions only (the import of the port never needs it)
        lazy = {id(n) for f in ast.walk(tree) if isinstance(f, ast.FunctionDef) for n in ast.walk(f)} \
            if path == PACKAGE / "viz.py" else set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] == "matplotlib" and id(node) in lazy:
                    continue
                assert name.split(".")[0] not in BLOCKED, f"{path.relative_to(REPO)}: imports {name}"


def test_entry_points_do_not_fall_back_to_cpu(monkeypatch, tmp_path):
    import torch

    from surfacenetworks_tpu_torch.cli import export_model, train_arap, train_correspondence, train_normal
    from surfacenetworks_tpu_torch.models import LapDeepModel
    from surfacenetworks_tpu_torch.serve import NormalServer, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NormalServer(LapDeepModel(3, 3, layers=15))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_correspondence.main(["--datapath", str(REPO / "tests" / "fixtures" / "faust"),
                                   "--result-dir", str(tmp_path), "--num-epoch", "1", "--num-updates", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_normal.main(["--data-path", str(REPO / "tests" / "fixtures" / "objs"), "--layer", "2",
                           "--result-dir", str(tmp_path), "--num-epoch", "1", "--num-updates", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_arap.main(["--data-path", str(REPO / "tests" / "fixtures" / "arap"), "--layer", "2",
                         "--result-dir", str(tmp_path), "--num-epoch", "1", "--num-updates", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_model.main(["--synthetic", "--layer", "2", "--out", str(tmp_path / "m.snx")])
    assert not (tmp_path / "m.snx").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_card_or_package(tmp_path):
    """No card: non-zero exit and no result line.  Alone in a directory (as
    if there were a card): the package import fails, non-zero exit."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout, res.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    alone = ("import runpy, torch; torch.cuda.is_available = lambda: True; "
             "runpy.run_path('chip_smoke.py', run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", alone], cwd=tmp_path, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and '"ok"' not in res.stdout, res.stdout
    assert "surfacenetworks_tpu_torch" in res.stderr, res.stderr[-2000:]
