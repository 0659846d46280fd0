"""Host-side geometry (counterpart of ``surfacenetworks_tpu/geometry``)."""

from surfacenetworks_tpu_torch.geometry import coarsening, graph_ops, intrinsic, repair
from surfacenetworks_tpu_torch.geometry.io import load_obj, load_ply, save_obj, save_ply
from surfacenetworks_tpu_torch.geometry.mesh_ops import (
    DiracCoeffs,
    cotangent_weights,
    dirac,
    dirac_coeffs,
    dist_matrix,
    edge_lengths,
    face_areas,
    hackit,
    igl_style_laplacian,
    invert_permutation,
    laplacian,
    mesh_laplacian,
    quaternion_matrix,
    uniform_mesh_scale,
    vertex_normals,
)

__all__ = [
    "DiracCoeffs",
    "coarsening",
    "cotangent_weights",
    "dirac",
    "dirac_coeffs",
    "dist_matrix",
    "edge_lengths",
    "face_areas",
    "graph_ops",
    "hackit",
    "igl_style_laplacian",
    "intrinsic",
    "invert_permutation",
    "laplacian",
    "load_obj",
    "load_ply",
    "mesh_laplacian",
    "quaternion_matrix",
    "repair",
    "save_obj",
    "save_ply",
    "uniform_mesh_scale",
    "vertex_normals",
]
