"""The yardstick's counts against hand counts on an octahedron (6
vertices, 8 faces, 12 edges)."""

import numpy as np

from portbench import work

OCTA_F = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4], [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])


def test_mesh_counts():
    assert work.mesh_edges(OCTA_F) == 12
    assert work.laplacian_nnz(6, 12) == 30  # 6 diagonal + 2 x 12


def test_apply_work():
    # 30 nonzeros x (4 B index + 4 B value) + x and out, 6 rows x 8 channels x 4 B each
    assert work.lap_apply_bytes(6, 30, 8) == 240 + 2 * 192
    assert work.apply_flops(30, 8) == 480
    # 24 corners x (16 B quaternion + 4 B index) + (6 + 8 rows) x 8 channels x 4 B
    assert work.dirac_apply_bytes(6, 8, 24, 8) == 480 + 448
    assert work.dirac_apply_flops(24, 8) == 24 * 2 * 16 * 2


def test_bound_takes_the_longer():
    assert work.bound_s(3.35e12, 0) == 1.0
    assert work.bound_s(0, 67e12) == 1.0


def test_model_flops_by_hand():
    # one Lap layer at width 4 on the octahedron: conv1 3->4 (forward 2*3*4, weight grad the same) a vertex,
    # two 8->4 maps (forward, weight and input grads), two applies forward and backward, conv2 4->3
    v, f, e, c = 6, 8, 12, 4
    expected = v * (2 * 3 * 4 * 2) + v * (2 * 4 * 3 * 3) + 2 * v * (2 * 8 * 4 * 3) + 4 * 2 * 30 * c
    assert work.deep_model_flops("lap", 1, c, v, f, e) == expected
    # one Dirac layer: the face map and the vertex map, four applies of 24 live corners
    expected_dirac = (v * (2 * 3 * 4 * 2) + v * (2 * 4 * 3 * 3) + f * (2 * 8 * 4 * 3) + v * (2 * 8 * 4 * 3)
                      + 4 * 24 * 8 * c)
    assert work.deep_model_flops("dirac", 1, c, v, f, e) == expected_dirac
    # an odd (average) layer adds two maps and no apply
    assert work.deep_model_flops("lap", 2, c, v, f, e) - expected == 2 * v * (2 * 8 * 4 * 3)


def test_window_work_sums_each_updates_meshes():
    from portbench import bench

    cell = bench.Cell("", {"name": "w"}, {"operator": "lap", "layers": 1, "width": 4}, {}, [])
    octa = (6, 8, 12)
    big = (10, 16, 24)
    ctx = bench.Context(cell, 1.0, [[0, 1], [1]], [octa, big])
    assert ctx.steps == 2
    assert ctx.update_sums(lambda v, f, e: (v, f)) == [(16, 24), (10, 16)]
    flops = lambda s: work.deep_model_flops("lap", 1, 4, *s)  # noqa: E731
    assert ctx.window_flops() == flops(octa) + 2 * flops(big)


def test_host_work_leaves_out_waits_on_the_device():
    from portbench import trace

    t = trace.Trace.__new__(trace.Trace)
    # one span of 100 ns; launches of least cost 2, one of them waiting 30 more in a full queue; a
    # synchronise of 20 (all of it a wait); a launch on another thread (the backward's) waiting 5 more,
    # and a call outside the span, which does not count
    t.host_ranges = {"portbench:host:update": [(0, 100)]}
    t.runtime = [(10, 12, "cudaLaunchKernel"), (20, 52, "cudaLaunchKernel"), (60, 80, "cudaStreamSynchronize"),
                 (85, 92, "cudaLaunchKernel"), (150, 190, "cudaLaunchKernel")]
    work_s, wall_s = t.host_work_s()
    assert wall_s == 100e-9
    assert abs(work_s - (100 - 30 - 20 - 5) * 1e-9) < 1e-15
