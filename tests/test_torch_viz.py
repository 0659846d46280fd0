"""The port's ``viz.py`` and ``MetricsLogger.plot`` against the JAX
package's on the CPU (matplotlib's Agg backend).

* ``render_mesh``, ``render_comparison``, ``animate_sequence``,
  ``quiver_operator`` and ``plot_curves`` each write their file, and its
  decoded pixels (every GIF frame) equal those the JAX package's ``viz``
  writes from the same inputs, exactly: both are the same matplotlib code.
* ``MetricsLogger.plot`` writes ``<prefix>_curves.png`` beside the metrics
  file, and returns None (the run goes on) where matplotlib cannot be
  imported, and where there is no file.
* One CPU run of each of the five trainers leaves its curves beside its
  metrics.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
from PIL import Image, ImageSequence

from surfacenetworks_tpu import viz as jviz
from surfacenetworks_tpu_torch import viz as tviz
from surfacenetworks_tpu_torch.cli.common import MetricsLogger
from surfacenetworks_tpu_torch.data import datasets as tdatasets
from surfacenetworks_tpu_torch.geometry import igl_style_laplacian

FIX = pathlib.Path(__file__).parent / "fixtures"


def _pixels(path) -> list[np.ndarray]:
    with Image.open(path) as im:
        return [np.asarray(frame.convert("RGBA")) for frame in ImageSequence.Iterator(im)]


def _mesh():
    V, F = tdatasets.random_blob_mesh(np.random.default_rng(3), 120)
    return V, F


def _metrics(path):
    with open(path, "w") as f:
        for e in range(3):
            f.write(json.dumps({"epoch": e, "split": "train", "time": 0.0, "loss": 1.0 / (e + 1), "mad": 0.5}) + "\n")
            f.write(json.dumps({"epoch": e, "split": "test", "time": 0.0, "loss": 1.2 / (e + 1)}) + "\n")
    return str(path)


def _call(mod, name: str, tmp: pathlib.Path):
    V, F = _mesh()
    out = str(tmp / f"{name}.{'gif' if name == 'animate_sequence' else 'png'}")
    if name == "render_mesh":
        return mod.render_mesh(V, F, out, color=V[:, 2], title="blob")
    if name == "render_comparison":
        return mod.render_comparison(V, V * 1.1, V * 0.9, F, out)
    if name == "animate_sequence":
        frames = [V * (1 + 0.05 * i) for i in range(4)]
        return mod.animate_sequence(frames, F, out, pred_frames=[f * 0.98 for f in frames])
    if name == "quiver_operator":
        return mod.quiver_operator(V, F, igl_style_laplacian(V, F) @ V, out)
    return mod.plot_curves(_metrics(tmp / "run.metrics.jsonl"), out)


@pytest.mark.parametrize("name", ["render_mesh", "render_comparison", "animate_sequence", "quiver_operator",
                                  "plot_curves"])
def test_viz_matches_jax(name, tmp_path):
    """The same inputs through both packages: the same pixels, frame by
    frame."""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _call(tviz, name, tmp_path / "port")
    ref = _call(jviz, name, tmp_path / "jax")
    assert got.startswith(str(tmp_path / "port")) and pathlib.Path(got).stat().st_size > 0
    a, b = _pixels(got), _pixels(ref)
    assert len(a) == len(b) == (4 if name == "animate_sequence" else 1)
    for fa, fb in zip(a, b):
        assert fa.shape == fb.shape and fa.std() > 0
        np.testing.assert_array_equal(fa, fb)


def test_metrics_logger_plot(tmp_path, monkeypatch):
    """The curves file beside the metrics; None without matplotlib (the
    trainers call it after every test epoch) and without a file."""
    log = MetricsLogger("run", str(tmp_path))
    assert log.plot() is None  # nothing written yet
    log.write(0, "train", loss=1.0, mad=0.4)
    log.write(0, "test", loss=1.5, mad=0.5)
    log.write(1, "train", loss=0.7, mad=0.3)
    path = log.plot()
    assert path == str(tmp_path / "run_curves.png") and _pixels(path)[0].std() > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import matplotlib now raises ImportError
    (tmp_path / "run_curves.png").unlink()
    assert log.plot() is None and not (tmp_path / "run_curves.png").exists()
    assert MetricsLogger("run", str(tmp_path), debug=True).plot() is None


TRAINERS = {
    "train_normal": (["--data-path", str(FIX / "objs"), "--layer", "2", "--num-epoch", "1", "--num-updates", "1",
                      "--batch-size", "2"], "debug"),
    "train_correspondence": (["--datapath", str(FIX / "faust"), "--layer", "2", "--num-epoch", "1", "--num-updates",
                              "1", "--deser-option", "no"], "test"),
    "train_arap": (["--data-path", str(FIX / "arap"), "--layer", "2", "--num-epoch", "1", "--num-updates", "1",
                    "--batch-size", "4"], "test"),
    "train_mnist": (["--data-path", str(FIX / "mnist_plus.np"), "--layer", "2", "--num-epoch", "1", "--batch-size",
                     "4"], "mnist"),
    "train_vae": (["--data-path", str(FIX / "mnist_plus.np"), "--num-layers", "2", "--num-epoch", "1",
                   "--batch-size", "4"], "vae"),
}


@pytest.mark.parametrize("trainer", sorted(TRAINERS))
def test_trainers_draw_their_curves(trainer, tmp_path):
    """``main`` on the fixture, one epoch: rank 0 draws the curves after
    the test pass, as the JAX trainers do."""
    import importlib

    argv, prefix = TRAINERS[trainer]
    importlib.import_module(f"surfacenetworks_tpu_torch.cli.{trainer}").main(
        argv + ["--device", "cpu", "--result-dir", str(tmp_path)])
    curves = tmp_path / "log" / f"{prefix}_curves.png"
    assert (tmp_path / "log" / f"{prefix}.metrics.jsonl").exists() and curves.exists()
    assert _pixels(curves)[0].std() > 0
