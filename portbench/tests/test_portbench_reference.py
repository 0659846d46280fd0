"""Each plain reference against the port at a tiny size on the CPU: the
operators it works out again, and one forward and backward of the model
from the same initialisation on a padded batch (so that padding rows enter
the batch norms on both sides).  This test imports both; the references
import nothing of the port."""

import numpy as np
import pytest
import torch

from portbench import meshes
from portbench.reference import dir15, lap15, plain


@pytest.fixture
def two_meshes():
    rng = meshes.mesh_rng(2**33 + 5)
    return [meshes.blob_mesh(rng, 60), meshes.blob_mesh(rng, 50)]


def _dense(m):
    return np.asarray(m.todense(), dtype=np.float64)


def test_operators_match_the_port(two_meshes):
    from surfacenetworks_tpu_torch import geometry

    for V, F in two_meshes:
        np.testing.assert_allclose(_dense(plain.cot_laplacian(V, F)), _dense(geometry.igl_style_laplacian(V, F)),
                                   rtol=1e-5, atol=1e-5 * np.abs(_dense(plain.cot_laplacian(V, F))).max())
        D, DA = plain.dirac_pair(V, F)
        D0, DA0 = geometry.dirac(V, F)
        np.testing.assert_allclose(_dense(D), _dense(D0), rtol=1e-5, atol=1e-6 * np.abs(_dense(D0)).max())
        np.testing.assert_allclose(_dense(DA), _dense(DA0), rtol=1e-5, atol=1e-6 * np.abs(_dense(DA0)).max())
        np.testing.assert_allclose(plain.vertex_normals(V, F), geometry.vertex_normals(V, F), atol=1e-12)


def _port_batch(kind, two_meshes):
    from surfacenetworks_tpu_torch import geometry, native
    from surfacenetworks_tpu_torch.data import Buckets, dirac_batch, laplacian_batch

    samples = []
    for V, F in two_meshes:
        s = {"V": V.astype(np.float32), "F": F, "input": V.astype(np.float32),
             "target": geometry.vertex_normals(V, F).astype(np.float32)}
        if kind == "lap":
            s["L"] = geometry.igl_style_laplacian(V, F)
        else:
            s["dirac"] = native.dirac_coeffs(V, F)
        samples.append(s)
    buckets = Buckets.for_samples(samples)
    if kind == "lap":
        return laplacian_batch(samples, buckets, fmt="ell"), buckets
    return dirac_batch(samples, buckets), buckets


@pytest.mark.parametrize("kind,ref", [("lap", lap15), ("dirac", dir15)])
def test_forward_and_backward_match_the_port(kind, ref, two_meshes):
    from surfacenetworks_tpu_torch.models import DirDeepModel, LapDeepModel, init_weights
    from surfacenetworks_tpu_torch.train import losses

    layers = 3
    from surfacenetworks_tpu_torch.data.pipeline import _map_tensors

    # in float64 on both sides, so that what is compared is the arithmetic and not fp32's rounding; the
    # operators' float32 entries, worked out apart on the two sides, may differ in their last bit
    batch, buckets = _port_batch(kind, two_meshes)
    batch = _map_tensors(batch, lambda t: t.double() if t.is_floating_point() else t)
    model = (LapDeepModel if kind == "lap" else DirDeepModel)(3, 3, layers=layers)
    init_weights(model, torch.Generator().manual_seed(0))
    model.double()
    loss = losses.normal_cosine_loss(model(batch.operator, batch.mask, batch.inputs), batch.mask, batch.targets)
    loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}

    problem = ref.build({"layers": layers}, two_meshes, "cpu", torch.float64)
    params = problem.params()
    assert set(params) == set(grads)
    for n, p in model.named_parameters():
        torch.testing.assert_close(params[n].detach(), p.detach(), rtol=0, atol=0)  # the same initialisation
    ref_loss = problem.loss(params, ([0, 1], buckets.n_vertices, buckets.n_faces))
    ref_loss.backward()
    assert abs(float(ref_loss.detach()) - float(loss.detach())) <= 1e-8 * abs(float(loss.detach()))
    # against each leaf's largest element, or the median leaf's where the leaf's gradient is nought to
    # rounding (a bias under a batch norm)
    floor = float(np.median([float(g.abs().max()) for g in grads.values()]))
    for n, g in grads.items():
        scale = max(float(g.abs().max()), floor)
        assert float((params[n].grad - g).abs().max()) <= 1e-6 * scale, n
