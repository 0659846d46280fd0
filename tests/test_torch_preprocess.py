"""The port's offline preprocessing (``cli/preprocess.py``, the mesh-MNIST
sampler's dataset pass and the MNIST idx reader) against the JAX package's.

Both packages' ``preprocess`` run on the same idx files, ``.obj`` trees and
frame directories with the same seeds; their files must hold the same
arrays, bit for bit, and each package's loaders must read the other's
files to the same samples.  The trainers then read what the port wrote.
``--workers`` stays at 1 or 2 here.
"""

import gzip
import os
import struct

import numpy as np
import pytest

from surfacenetworks_tpu.cli import preprocess as jax_preprocess
from surfacenetworks_tpu.data import datasets as jax_datasets
from surfacenetworks_tpu_torch.cli import preprocess
from surfacenetworks_tpu_torch.data import datasets

from torch_parity import DIRAC_FIELDS, assert_same

FIXTURE_OBJS = os.path.join(os.path.dirname(__file__), "fixtures", "objs")


def _write_idx(tmp_path, images, labels, gz=False, image_magic=2051, label_magic=2049, n_labels=None):
    ip = tmp_path / ("img.idx" + (".gz" if gz else ""))
    lp = tmp_path / ("lbl.idx" + (".gz" if gz else ""))
    opener = gzip.open if gz else open
    with opener(ip, "wb") as fh:
        fh.write(struct.pack(">IIII", image_magic, len(images), 28, 28))
        fh.write(np.asarray(images, np.uint8).tobytes())
    with opener(lp, "wb") as fh:
        fh.write(struct.pack(">II", label_magic, len(labels) if n_labels is None else n_labels))
        fh.write(np.asarray(labels, np.uint8).tobytes())
    return str(ip), str(lp)


def _fake_digits(n=3, seed=0):
    """``tests/test_mnist_data.py``'s digits: a 12x12 block of 220 at a
    random offset, random labels."""
    rng = np.random.default_rng(seed)
    imgs = np.zeros((n, 28, 28), np.uint8)
    for i in range(n):
        r0, c0 = rng.integers(4, 10, 2)
        imgs[i, r0 : r0 + 12, c0 : c0 + 12] = 220
    labels = rng.integers(0, 10, n).astype(np.uint8)
    return imgs, labels


def _without_name(samples):
    return [{k: v for k, v in s.items() if k != "name"} for s in samples]


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_load_mnist_idx_matches_jax(tmp_path, gz):
    imgs, labels = _fake_digits()
    ip, lp = _write_idx(tmp_path, imgs, labels, gz=gz)
    im, lb = datasets.load_mnist_idx(ip, lp)
    np.testing.assert_array_equal(im, imgs)
    np.testing.assert_array_equal(lb, labels)
    assert im.dtype == np.uint8 and lb.dtype == np.int64
    jim, jlb = jax_datasets.load_mnist_idx(ip, lp)
    assert_same(im, jim)
    assert_same(lb, jlb)


@pytest.mark.parametrize("bad", ["image_magic", "label_magic", "count"])
def test_load_mnist_idx_errors_match_jax(tmp_path, bad):
    imgs, labels = _fake_digits(2)
    kw = {"image_magic": {"image_magic": 2049}, "label_magic": {"label_magic": 2051},
          "count": {"n_labels": 3}}[bad]
    ip, lp = _write_idx(tmp_path, imgs, labels, **kw)
    with pytest.raises(ValueError) as port_err:
        datasets.load_mnist_idx(ip, lp)
    with pytest.raises(ValueError) as jax_err:
        jax_datasets.load_mnist_idx(ip, lp)
    assert str(port_err.value) == str(jax_err.value)
    assert {"image_magic": "bad idx image magic", "label_magic": "bad idx label magic",
            "count": "count mismatch"}[bad] in str(port_err.value)


def test_build_mnist_mesh_dataset_matches_jax():
    imgs, labels = _fake_digits(2, seed=1)
    got = datasets.build_mnist_mesh_dataset(imgs, labels, seed=1)
    ref = jax_datasets.build_mnist_mesh_dataset(imgs, labels, seed=1)
    assert len(got) == len(ref) >= 1
    assert_same(got, ref)
    meshes = datasets.build_mnist_mesh_dataset(imgs, labels, seed=1, with_operators=False, limit=1)
    assert_same(meshes, jax_datasets.build_mnist_mesh_dataset(imgs, labels, seed=1, with_operators=False, limit=1))


@pytest.fixture(scope="module")
def mnist_files(tmp_path_factory):
    """Both packages' ``preprocess mnist`` on the same four digits and seed."""
    tmp = tmp_path_factory.mktemp("mnist")
    imgs, labels = _fake_digits(4, seed=2)
    ip, lp = _write_idx(tmp, imgs, labels, gz=True)
    port, ref = str(tmp / "port" / "train_plus.np"), str(tmp / "jax" / "train_plus.np")
    argv = ["mnist", "--images", ip, "--labels", lp, "--seed", "5", "--workers", "2"]
    preprocess.main(argv + ["--out", port])
    jax_preprocess.main(argv + ["--out", ref])
    return port, ref


def test_preprocess_mnist_matches_jax(mnist_files):
    port, ref = mnist_files
    raw_port = np.load(port, allow_pickle=True, encoding="latin1")
    raw_ref = np.load(ref, allow_pickle=True, encoding="latin1")
    assert len(raw_port) == len(raw_ref) >= 3
    assert_same(raw_port, raw_ref)
    # the Dirac members are the JAX package's class in the file
    from surfacenetworks_tpu.geometry.mesh_ops import DiracCoeffs as JaxDirac

    assert all(type(s[k]) is JaxDirac for s in raw_port for k in ("dirac", "flat_dirac"))


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_preprocess_mnist_loaders_read_both(mnist_files, reader):
    port, ref = mnist_files
    load = datasets.load_mnist_mesh_pickle if reader == "port" else jax_datasets.load_mnist_mesh_pickle
    assert_same(load(port), load(ref))
    if reader == "port":
        from surfacenetworks_tpu_torch.geometry import DiracCoeffs

        assert all(type(s["dirac"]) is DiracCoeffs for s in load(port))


def test_preprocess_mnist_pickle_refuses_other_globals(tmp_path):
    """The port's reader admits the JAX package's ``DiracCoeffs`` and no
    other global of that package (its unpickler is not widened)."""
    import pickle

    path = tmp_path / "other.np"
    path.write_bytes(b"\x80\x03" + pickle.GLOBAL + b"surfacenetworks_tpu.geometry.mesh_ops\ndirac\n" + pickle.STOP)
    with pytest.raises(pickle.UnpicklingError, match="refused global"):
        datasets.load_mnist_mesh_pickle(str(path))


@pytest.fixture(scope="module")
def normal_files(tmp_path_factory):
    """Both packages' ``preprocess normal`` (lap and dirac) on the fixture
    ``.obj`` tree."""
    tmp = tmp_path_factory.mktemp("normal")
    out = {}
    for op in ("lap", "dirac"):
        for name, main in (("port", preprocess.main), ("jax", jax_preprocess.main)):
            d = str(tmp / f"{name}_{op}")
            main(["normal", "--data-path", FIXTURE_OBJS, "--out", d, "--operator", op, "--workers", "2"])
            out[name, op] = d
    return out


@pytest.mark.parametrize("op", ["lap", "dirac"])
def test_preprocess_normal_matches_jax(normal_files, op):
    port = datasets.scan_mesh_tree(normal_files["port", op])
    ref = jax_datasets.scan_mesh_tree(normal_files["jax", op])
    assert [os.path.basename(p) for p in port] == [os.path.basename(p) for p in ref] and len(port) >= 2
    for p, r in zip(port, ref):
        with np.load(p, allow_pickle=True) as zp, np.load(r, allow_pickle=True) as zr:
            assert sorted(zp.files) == sorted(zr.files)
            for key in zp.files:
                assert_same(zp[key], zr[key], f"{os.path.basename(p)}:{key}")


@pytest.mark.parametrize("op", ["lap", "dirac"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_preprocess_normal_loaders_read_both(normal_files, op, reader):
    load = datasets.load_normal_npz if reader == "port" else jax_datasets.load_normal_npz
    port = sorted(datasets.scan_mesh_tree(normal_files["port", op]))
    ref = sorted(datasets.scan_mesh_tree(normal_files["jax", op]))
    for p, r in zip(port, ref):
        assert_same(_without_name([load(p)]), _without_name([load(r)]))
    # and the port's .npz sample equals the lazy .obj sample it came from
    obj = datasets.scan_obj_tree(FIXTURE_OBJS)[0]
    lazy = datasets.load_normal_sample(obj, operator=op)
    got = load(os.path.join(normal_files["port", op], os.path.splitext(os.path.basename(obj))[0] + ".npz"))
    for key in ("V", "F", "target"):
        assert_same(got[key], lazy[key])
    if op == "lap":
        assert_same(got["L"], lazy["L"].tocsr())
    else:
        for f in DIRAC_FIELDS:
            assert_same(getattr(got["dirac"], f), getattr(lazy["dirac"], f))


def _write_frames(root, n_seq=2, n_frames=44, n_points=40, seed=3):
    """Per-frame ``.obj`` sequence directories of ``arap_wave_frames``."""
    from surfacenetworks_tpu_torch import geometry as geo

    for s, (frames, F) in enumerate(datasets.arap_wave_frames(n_seq, n_frames, n_points, seed)):
        d = root / f"seq{s:02d}"
        d.mkdir(parents=True)
        for t, V in enumerate(frames):
            geo.save_obj(str(d / f"frame{t:03d}.obj"), V, F)
    (root / "not_a_sequence.txt").write_text("ignored")


@pytest.fixture(scope="module")
def arap_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("arap")
    _write_frames(tmp / "seqs")
    out = {}
    for name, main in (("port", preprocess.main), ("jax", jax_preprocess.main)):
        out[name] = str(tmp / name)
        main(["arap", "--data-path", str(tmp / "seqs"), "--out", out[name], "--workers", "2"])
    return out


def test_preprocess_arap_matches_jax(arap_files):
    names = sorted(os.listdir(arap_files["port"]))
    assert names == sorted(os.listdir(arap_files["jax"])) == ["seq00.npy", "seq01.npy"]
    for n in names:
        got = np.load(os.path.join(arap_files["port"], n), allow_pickle=True, encoding="latin1")
        ref = np.load(os.path.join(arap_files["jax"], n), allow_pickle=True, encoding="latin1")
        assert_same(got, ref, n)
        assert ["L" in f for f in got] == [True] * 10 + [False] * 34


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_preprocess_arap_loaders_read_both(arap_files, reader):
    load = datasets.load_arap_sequence if reader == "port" else jax_datasets.load_arap_sequence
    for n in sorted(os.listdir(arap_files["port"])):
        assert_same(load(os.path.join(arap_files["port"], n)), load(os.path.join(arap_files["jax"], n)))


def _finite(history) -> bool:
    vals = np.asarray([v for epoch in history["train"] + history["test"] for v in np.atleast_1d(epoch)], np.float64)
    return vals.size > 0 and bool(np.isfinite(vals).all())


def test_trainers_read_the_ports_files(tmp_path, mnist_files, normal_files, arap_files):
    """``train_mnist``/``train_vae --data-path`` on the port's pickle,
    ``train_normal --data-path`` on its ``.npz`` trees (lap and dirac) and
    ``train_arap --data-path`` on its sequences train an epoch each on the
    CPU, with finite losses."""
    from surfacenetworks_tpu_torch.cli import train_arap, train_mnist, train_normal, train_vae

    def common(label):
        return ["--device", "cpu", "--num-epoch", "1", "--result-dir", str(tmp_path / label)]

    runs = {
        "mnist": train_mnist.main(["--data-path", mnist_files[0], "--layer", "2", "--batch-size", "2",
                                   *common("mnist")]),
        "vae": train_vae.main(["--data-path", mnist_files[0], "--num-layers", "2", "--batch-size", "2",
                               *common("vae")]),
        "arap": train_arap.main(["--data-path", arap_files["port"], "--layer", "2", "--num-updates", "1",
                                 "--batch-size", "2", *common("arap")]),
    }
    for op in ("lap", "dirac"):
        runs[f"normal {op}"] = train_normal.main([
            "--data-path", normal_files["port", op], "--model", op, "--layer", "2", "--num-updates", "1",
            "--batch-size", "1", "--operator-format", "ell", *common(f"normal_{op}")])
    for label, hist in runs.items():
        assert len(hist["train"]) == 1 and _finite(hist), f"{label}: {hist}"
