"""ARAP ``--dump-rollout`` on the CPU against the JAX trainer's dump
(``surfacenetworks_tpu/cli/train_arap.py:419-439``), on the fixture
sequences at 2 layers:

* ``rollout_gt.npy`` equals JAX's construction bit for bit: its first test
  batch (the test counter reset) through the JAX package's ``arap_batch``,
  the targets' 40 frames of item 0 over the first test sequence's vertices;
* ``rollout_pred.npy`` equals the port's forward on that test pick, masked,
  bit for bit, and lies within the ARAP family's fp32 rule of JAX's
  ``model.apply`` on the same (converted) weights: no farther from the fp64
  forward than FP32_RATIO x JAX's own fp32 distance, plus 1e-6 (relative
  Frobenius, as ``tests/test_torch_arap.py``);
* ``main --dump-rollout DIR`` writes both files and ``rollout.gif`` with
  JAX's ``OUTPUT_FRAMES`` (40) frames, the prediction equal to the forward
  of the run's checkpoint, and the run's curves;
* where matplotlib is missing, the flag is refused at the start, with a
  message naming it (the JAX trainer fails only after training).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.cli import train_arap as jtrain
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.data import datasets as jdatasets
from surfacenetworks_tpu_torch.cli import train_arap as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax

from torch_parity import perturbed_params, rel_fro

ARAP = pathlib.Path(__file__).parent / "fixtures" / "arap"
FP32_RATIO = 10


def _argv(tmp_path, *extra):
    return ["--device", "cpu", "--data-path", str(ARAP), "--layer", "2", "--batch-size", "4", "--num-epoch", "1",
            "--num-updates", "2", "--result-dir", str(tmp_path), *extra]


def _forward(model, batch):
    with torch.no_grad():
        return (model(batch.operator, batch.mask, batch.inputs) * batch.mask).numpy()


def test_rollout_matches_jax(tmp_path):
    trainer = ttrain.ArapTrainer(ttrain.parser.parse_args(_argv(tmp_path)), log=lambda _: None)
    seqs = [jdatasets.load_arap_sequence(str(f)) for f in sorted(ARAP.glob("*.npy"))]
    jbk = jbat.Buckets.for_samples([{"V": s[0]["V"], "F": s[0]["F"]} for s in seqs])
    first = trainer.sample_test_picks()
    trainer.sample_test_picks()  # dump_rollout starts the test counter afresh, as the JAX trainer does
    jb = jbat.arap_batch(seqs, first, jbk, model="lap", fmt="ell")
    jm = jtrain.MODELS["lap"](layers=2)
    op = jax.tree_util.tree_map(jnp.asarray, jb.operator)
    params = perturbed_params(jm.init(jax.random.key(0), op, jnp.asarray(jb.mask), jnp.asarray(jb.inputs))["params"],
                              31)
    trainer.model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params), like=trainer.model))

    pred, gt, faces = ttrain.dump_rollout(trainer, str(tmp_path / "roll"))
    assert (tmp_path / "roll" / "rollout_pred.npy").exists() and (tmp_path / "roll" / "rollout_gt.npy").exists()
    np.testing.assert_array_equal(np.load(tmp_path / "roll" / "rollout_pred.npy"), pred)
    np.testing.assert_array_equal(np.load(tmp_path / "roll" / "rollout_gt.npy"), gt)
    seq = seqs[trainer.n_train if len(seqs) > trainer.n_train else 0]
    n = seq[0]["V"].shape[0]
    frames = range(jtrain.OUTPUT_FRAMES)
    jgt = np.stack([jb.targets[0, :n, 3 * i:3 * (i + 1)] for i in frames])
    assert gt.shape == (40, n, 3) and gt.dtype == jgt.dtype
    np.testing.assert_array_equal(gt, jgt)
    np.testing.assert_array_equal(faces, np.asarray(seq[0]["F"], np.int32))

    batch = trainer.batch(first)
    out = _forward(trainer.model, batch)
    np.testing.assert_array_equal(pred, np.stack([out[0, :n, 3 * i:3 * (i + 1)] for i in frames]))
    b64 = batch
    b64.inputs, b64.mask = batch.inputs.double(), batch.mask.double()
    out64 = _forward(trainer.model.double(), b64)
    ref64 = np.stack([out64[0, :n, 3 * i:3 * (i + 1)] for i in frames])
    jout = np.asarray(jm.apply({"params": params}, op, jnp.asarray(jb.mask), jnp.asarray(jb.inputs)) * jb.mask)
    jpred = np.stack([jout[0, :n, 3 * i:3 * (i + 1)] for i in frames])
    assert rel_fro(pred, ref64) <= FP32_RATIO * rel_fro(jpred, ref64) + 1e-6, (rel_fro(pred, ref64),
                                                                               rel_fro(jpred, ref64))


def test_main_dump_rollout_writes_files_and_gif(tmp_path):
    from PIL import Image

    roll = tmp_path / "roll"
    ttrain.main(_argv(tmp_path, "--dump-rollout", str(roll)))
    pred = np.load(roll / "rollout_pred.npy")
    gt = np.load(roll / "rollout_gt.npy")
    assert pred.shape == gt.shape and pred.shape[0] == jtrain.OUTPUT_FRAMES == 40
    with Image.open(roll / "rollout.gif") as gif:
        assert gif.n_frames == 40
    trainer = ttrain.ArapTrainer(ttrain.parser.parse_args(_argv(tmp_path)), log=lambda _: None)
    ckpt = torch.load(tmp_path / "pts" / "test_2_lap.pt", weights_only=True)
    trainer.model.load_state_dict(ckpt["params"])
    again, _, _ = ttrain.dump_rollout(trainer, None)
    np.testing.assert_array_equal(again, pred)
    assert (tmp_path / "log" / "test_curves.png").exists()
    assert "rollout dumped to" in (tmp_path / "log" / "test.log").read_text()


def test_dump_rollout_refused_without_matplotlib(monkeypatch, tmp_path):
    """No matplotlib: refused before any data is read (the GIF needs it;
    ``dump_rollout`` writes the ``.npy`` files without it)."""
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if name == "matplotlib" else real(name, *a))
    with pytest.raises(SystemExit, match="--dump-rollout draws its GIF with matplotlib, which is not installed"):
        ttrain.main(["--device", "cpu", "--data-path", str(tmp_path / "absent"), "--dump-rollout", str(tmp_path)])
    ttrain.refuse_unported(ttrain.parser.parse_args(["--device", "cpu"]))
