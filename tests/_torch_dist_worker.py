"""Runs the port's multi-rank cases for ``tests/test_torch_dist_train.py``.

    python tests/_torch_dist_worker.py SPEC.json OUT_DIR

It imports only the port (never JAX).  ``SPEC.json`` holds ``ranks`` (the
gloo ranks started once, on the CPU) and a list of ``cases``.  A case of
``kind`` ``pspmm`` applies a row-partitioned operator and its backward on
each rank's rows, one of ``kind`` ``layers`` the sharded batch norm and
global average, ``dirac`` the partitioned Dirac pair's two applies and
their backwards, ``gat`` the partitioned attend and its gradients, and
``exchange`` the differentiable halo exchange and row all-gather (inputs
from an ``.npz`` file, each rank's outputs to
``OUT_DIR/<case>_r<rank>.npz``).  Any other case
names a trainer (``normal``, ``arap``, ``mnist``, ``vae``,
``correspondence``), its command
line, its ``(n_data, n_graph)`` grid (taken from the first ranks), an
optional ``.npz`` of initial parameters (``state_dict`` keys) and an
optional mutant (``local_bn``: batch-norm statistics rank-local), an
optional ``.npz`` of the first update's random draw (``draw``: the
mesh-MNIST dropout keep mask or the VAE's noise, of the whole batch) and
optional ``dtypes`` (``["32"]`` for a ``--bf16`` model, which computes in
bf16 whatever its parameters' dtype).  Under ``--rotate-augment`` the
normal trainer's update rotates by the trainer's own rotations (drawn for
the global batch, each rank's slice), and rank 0 also writes the global
batch's (``rotation``).
Every rank of a case's grid builds the trainer, draws the first global
batch (FAUST: the epoch plan's first pair and rotations) and takes one
update on its shard, once in fp64 (the model and the batch in fp64) and
once in fp32; rank 0 of the grid also takes both updates alone on the whole
batch (the single-device reference: under ``--graph-parallel`` the same
ordered, padded rows through the unpartitioned operator).  Each rank writes
``OUT_DIR/<case>_r<rank>.npz``: the losses, the fp64 gradients and the
parameters after each update.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import sys
from unittest import mock

import numpy as np
import torch

from surfacenetworks_tpu_torch import parallel_context
from surfacenetworks_tpu_torch.dist import mesh_setup
from surfacenetworks_tpu_torch.nn.layers import GraphBatchNorm
from surfacenetworks_tpu_torch.train import optim


def _cast(batch, dtype):
    """The batch's float arrays in ``dtype`` (the operator keeps its own)."""
    b = copy.copy(batch)
    b.inputs, b.mask = batch.inputs.to(dtype), batch.mask.to(dtype)
    if batch.targets.is_floating_point():
        b.targets = batch.targets.to(dtype)
    if batch.aux is not None:
        b.aux = {k: (v.to(dtype) if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
                 for k, v in batch.aux.items()}
    if isinstance(batch.operator, torch.Tensor):
        b.operator = batch.operator.to(dtype)
    return b


def _cast_pair(pair: dict, dtype) -> dict:
    """A FAUST pair's shape entries with their features in ``dtype``."""
    return dict(pair, da=dict(pair["da"], inputs=pair["da"]["inputs"].to(dtype), mask=pair["da"]["mask"].to(dtype)),
                db=dict(pair["db"], inputs=pair["db"]["inputs"].to(dtype), mask=pair["db"]["mask"].to(dtype)))


class _Case:
    """One trainer family: how to build it, draw the first global batch,
    shard it, and take one update."""

    def __init__(self, spec: dict, mesh):
        self.spec, self.mesh = spec, mesh
        kind, argv = spec["trainer"], spec["argv"] + ["--device", "cpu"]
        if kind == "normal":
            from surfacenetworks_tpu_torch.cli import train_normal as m
            self.trainer = m.NormalTrainer(m.parser.parse_args(argv), log=lambda _: None, mesh=mesh)
            self.samples = self.trainer.train_sampler.next_batch()
        elif kind == "arap":
            from surfacenetworks_tpu_torch.cli import train_arap as m
            self.trainer = m.ArapTrainer(m.parser.parse_args(argv), log=lambda _: None, mesh=mesh)
            self.samples = self.trainer.sample_train_picks()
        elif kind == "mnist":
            from surfacenetworks_tpu_torch.cli import train_mnist as m
            self.trainer = m.MnistTrainer(m.parser.parse_args(argv), log=lambda _: None, mesh=mesh)
            self.samples = self.trainer.train_sampler.next_batch()
        elif kind == "correspondence":
            from surfacenetworks_tpu_torch.cli import train_correspondence as m
            self.trainer = m.CorrespondenceTrainer(m.parser.parse_args(argv), log=lambda _: None, mesh=mesh)
            pair_idx, rots = self.trainer.epoch_plan()
            self.samples = [(int(pair_idx[0][0]), int(pair_idx[0][1]), [float(r) for r in rots[0]])]
        else:
            from surfacenetworks_tpu_torch.cli import train_vae as m
            self.trainer = m.VaeTrainer(m.parser.parse_args(argv), log=lambda _: None, mesh=mesh)
            self.samples = self.trainer.train_sampler.next_batch()
        self.module, self.kind = m, kind
        if spec.get("state"):
            state = {k: torch.from_numpy(v) for k, v in np.load(spec["state"]).items()}
            self.trainer.model.load_state_dict(state, strict=True)
        self.state0 = copy.deepcopy(self.trainer.model.state_dict())
        n = len(self.samples)
        if spec.get("draw"):
            self.draw = torch.from_numpy(np.load(spec["draw"])["draw"])
        elif kind in ("mnist", "vae"):
            width = self.module.WIDTH if kind == "mnist" else self.module.LATENT
            gen = torch.Generator().manual_seed(spec.get("draw_seed", 5))
            self.draw = (torch.rand(n, width, generator=gen) < 0.5).float() if kind == "mnist" else torch.randn(
                n, width, generator=gen)

    def local_batch(self):
        t = self.trainer
        if self.kind == "correspondence":
            ia, ib, rots = self.samples[0]
            return {"da": t.dev_sample(ia), "db": t.dev_sample(ib), "rots": rots,
                    "target": t.local_rows(t.pair_target(ia, ib))}
        if self.kind == "normal":
            return t.batch(self.samples)
        return t.batch(self.samples, shard=True)

    def whole_batch(self):
        """The global batch on one device (under ``--graph-parallel`` the
        same ordered, padded rows through the unpartitioned operator: ELL,
        or the Dirac tables of the same coefficients)."""
        from surfacenetworks_tpu_torch import native
        from surfacenetworks_tpu_torch.data import arap_batch, correspondence_batch, dirac_batch, laplacian_batch
        from surfacenetworks_tpu_torch.sparse import dirac_from_coeffs, stack_dirac

        t = self.trainer
        gp = getattr(t, "n_gp", 1) > 1
        if self.kind == "correspondence":
            ia, ib, rots = self.samples[0]

            def entry(i):
                pack = correspondence_batch(t.data[i], t.buckets, fmt="ell", model=t.model_key)
                return {"op": pack.operator, "mask": pack.mask, "inputs": pack.inputs}

            return {"da": entry(ia), "db": entry(ib), "rots": rots, "target": t.pair_target(ia, ib)}
        if self.kind == "normal" and gp:
            tier = t.bucketset.tiers[t.bucketset.tier_index(self.samples)]
            if t.args.model == "dirac":
                op = stack_dirac([dirac_from_coeffs(native.dirac_coeffs(s["V"], s["F"]), tier.n_vertices, tier.n_faces,
                                                    tier.max_valence) for s in self.samples])
                return dirac_batch(self.samples, tier, operator=op)
            return laplacian_batch(self.samples, tier, fmt="ell")
        if self.kind == "normal":
            return t.batch(self.samples, shard=False)
        if gp and self.kind == "arap":
            return arap_batch(t.sequences, self.samples, t.buckets, model="dirac" if t.args.model == "dir" else "lap",
                              fmt="ell")
        if gp:  # mesh-MNIST and VAE: the trainer's bucket, unpartitioned operators
            from surfacenetworks_tpu_torch.data import mnist_batch, vae_batch

            return (mnist_batch if self.kind == "mnist" else vae_batch)(self.samples, t.buckets, model=t.kind,
                                                                       fmt="auto")
        return t.batch(self.samples)

    def step(self, model, opt, batch, mesh, dtype):
        """One update; returns the (global) loss."""
        m, draw = self.module, getattr(self, "draw", None)
        if mesh is not None and draw is not None:
            draw = draw[mesh_setup.batch_sharding(mesh, draw.shape[0])]
        if self.kind == "correspondence":
            t = self.trainer
            return m.train_step(model, opt, batch["da"], batch["db"], batch["rots"], batch["target"], 0.0, False,
                                None, t.loss_fn, None, mesh, t.args.loss)
        if self.kind == "normal":
            vertex = mesh is not None and mesh.n_graph > 1
            return m.train_step(model, opt, batch, rotation=self.rotation(batch, mesh, dtype), mesh=mesh,
                                vertex=vertex)[0]
        if self.kind == "arap":
            return m.train_step(model, opt, batch, mesh=mesh)
        if self.kind == "mnist":
            return m.train_step(model, opt, batch, draw.to(dtype), mesh=mesh)[0]
        return m.train_step(model, opt, batch, draw.to(dtype), 0.5, mesh=mesh)[0]

    def rotation(self, batch, mesh, dtype):
        """Under ``--rotate-augment`` the first update's rotations in
        ``dtype``: the trainer's own (drawn for the global batch, this
        rank's slice) on a grid, the global batch's alone."""
        t = self.trainer
        if not t.args.rotate_augment:
            return None
        rot = t.rotation(batch.inputs.shape[0]) if mesh is not None else self.module.step_rotations(
            t.args.seed, t.step, batch.inputs.shape[0], "cpu")
        return rot.to(dtype)

    def optimizer(self, model):
        wd = 0.0 if self.kind == "normal" else 1e-5
        return optim.adam(model.parameters(), 1e-3, weight_decay=wd)

    def run(self, model, batch, mesh, dtype) -> dict:
        model = model.to(dtype)
        model.load_state_dict(self.state0)
        opt = self.optimizer(model)
        loss = self.step(model, opt, _cast_pair(batch, dtype) if self.kind == "correspondence" else _cast(batch, dtype),
                         mesh, dtype)
        out = {"loss": np.asarray(float(loss))}
        for k, p in model.named_parameters():
            out[f"p.{k}"] = p.detach().double().numpy()
            if dtype == torch.float64:
                out[f"g.{k}"] = p.grad.detach().double().numpy()
        return out


def _local_bn():
    """The mutant: every batch norm takes its statistics over this rank's
    rows only (a different model from the global one)."""
    forward = GraphBatchNorm.forward

    def local(self, x, mask=None):
        with parallel_context.sharded_axes():
            return forward(self, x, mask)

    return mock.patch.object(GraphBatchNorm, "forward", local)


def _pspmm(case: dict, mesh) -> dict:
    """A partitioned apply and its backward on this rank's rows: the
    operator (csr arrays in the input file) partitioned on every rank,
    ``x`` and the cotangent ``g`` cut to the rank's rows, the apply through
    ``nn.blocks.apply_operator`` inside ``make_graph_sharded_apply``."""
    import scipy.sparse as sp

    from surfacenetworks_tpu_torch.dist import edge_partition as ep
    from surfacenetworks_tpu_torch.dist.graph_parallel import make_graph_sharded_apply
    from surfacenetworks_tpu_torch.nn.blocks import apply_operator

    f = np.load(case["input"])
    L = sp.csr_matrix((f["data"], f["indices"], f["indptr"]), shape=tuple(f["shape"]))
    op = ep.partition_operator(L, mesh.n_graph, halo=int(f["halo"]), k=int(f["k"]), interior_fmt=case["fmt"])
    g_idx = mesh.graph_index
    x = ep.shard_rows(torch.from_numpy(f["x"]), mesh.n_graph, g_idx).requires_grad_(True)
    run = make_graph_sharded_apply(mesh, lambda o, mask, v: apply_operator(o, v))
    y = run(ep.shard_partitioned(op, g_idx), None, x)
    y.backward(ep.shard_rows(torch.from_numpy(f["g"]), mesh.n_graph, g_idx))
    return {"y": y.detach().numpy(), "x_bar": x.grad.numpy()}


def _layers(case: dict, mesh) -> dict:
    """``GraphBatchNorm`` and ``global_average`` on this rank's block of
    ``[B, N, C]`` (its batch slice and rows) in the grid's sharded context,
    and their backward from the cotangents in the input file (the global
    average's, replicated over the graph axis, on its first rank only); the
    parameter gradients are this rank's shares."""
    from surfacenetworks_tpu_torch.nn.layers import global_average

    f = np.load(case["input"])
    sl = mesh_setup.batch_sharding(mesh, f["x"].shape[0])

    def block(a):
        a = torch.from_numpy(a)[sl]
        n = a.shape[1] // mesh.n_graph
        return a[:, mesh.graph_index * n:(mesh.graph_index + 1) * n].contiguous()

    x, mask = block(f["x"]).requires_grad_(True), block(f["mask"])
    bn = GraphBatchNorm(x.shape[-1], masked=bool(case.get("masked", False))).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(f["scale"]))
        bn.bias.copy_(torch.from_numpy(f["bias"]))
    with mesh.context(vertex=True):
        y = bn(x, mask)
        ga = global_average(x, mask)
    gga = torch.from_numpy(f["gga"])[sl]  # the replicated average's cotangent enters once: on graph rank 0
    torch.autograd.backward([y, ga], [block(f["gy"]), gga if mesh.graph_index == 0 else torch.zeros_like(gga)])
    return {"y": y.detach().numpy(), "ga": ga.detach().numpy(), "x_bar": x.grad.numpy(),
            "scale_bar": bn.weight.grad.numpy(), "bias_bar": bn.bias.grad.numpy()}


def _rows(a: np.ndarray, mesh) -> torch.Tensor:
    """This rank's rows (axis 1) of a whole ``[B, n, ...]`` array."""
    n = a.shape[1] // mesh.n_graph
    return torch.from_numpy(a[:, mesh.graph_index * n:(mesh.graph_index + 1) * n].copy())


def _dirac(case: dict, mesh) -> dict:
    """``Di v`` and ``DiA f`` on this rank's rows of a partitioned Dirac pair
    (the coefficients in the input file, partitioned on every rank) and
    their backwards from the cotangents ``gf`` and ``gv``, through
    ``nn.blocks.apply_dirac_vf`` / ``_fv`` in the graph-sharded context."""
    from surfacenetworks_tpu_torch.dist import dirac_partition as dp
    from surfacenetworks_tpu_torch.geometry.mesh_ops import DiracCoeffs
    from surfacenetworks_tpu_torch.nn.blocks import apply_dirac_fv, apply_dirac_vf

    f = np.load(case["input"])
    coeffs = DiracCoeffs(**{k: f[k] for k in ("F", "q_fv", "vf_face", "vf_corner", "q_vf", "q_bwd_v", "q_bwd_f")},
                         n_vertices=int(f["n_vertices"]), n_faces=int(f["n_faces"]))
    op = dp.stack_partitioned_dirac([dp.partition_dirac(coeffs, mesh.n_graph, int(f["N"]), int(f["M"]))])
    v, fa = _rows(f["v"], mesh).requires_grad_(True), _rows(f["f"], mesh).requires_grad_(True)
    with mesh.context(vertex=True, batch=False):
        y_vf, y_fv = apply_dirac_vf(dp.shard_partitioned_dirac(op, mesh.graph_index), v), apply_dirac_fv(
            dp.shard_partitioned_dirac(op, mesh.graph_index), fa)
    torch.autograd.backward([y_vf, y_fv], [_rows(f["gf"], mesh), _rows(f["gv"], mesh)])
    return {"vf": y_vf.detach().numpy(), "fv": y_fv.detach().numpy(), "v_bar": v.grad.numpy(),
            "f_bar": fa.grad.numpy(), "halo_v": op.halo_v, "halo_f": op.halo_f}


def _gat(case: dict, mesh) -> dict:
    """``gat_attend`` on this rank's rows of a row-partitioned operator (the
    csr arrays in the input file, partitioned on every rank) and its
    gradients from the cotangent ``g``."""
    import scipy.sparse as sp

    from surfacenetworks_tpu_torch.dist import graph_parallel as gp
    from surfacenetworks_tpu_torch.nn.blocks import gat_attend

    f = np.load(case["input"])
    L = sp.csr_matrix((f["data"], f["indices"], f["indptr"]), shape=tuple(f["shape"]))
    op = gp.partition_batch_operator([L], mesh.n_graph, n_rows=int(f["N"]), halo=int(f["halo"]), k=16)
    args = [_rows(f[k], mesh).requires_grad_(True) for k in ("xh", "ss", "sd")]
    with mesh.context(vertex=True, batch=False):
        out = gat_attend(gp.shard_operator(op, mesh.graph_index), *args)
    out.backward(_rows(f["g"], mesh))
    return {"out": out.detach().numpy(), **{f"{k}_bar": a.grad.numpy() for k, a in zip(("xh", "ss", "sd"), args)}}


def _exchange(case: dict, mesh) -> dict:
    """``halo_exchange`` of this rank's rows of ``x`` and ``gather_rows`` of
    them, each backward from this rank's cotangent in the input file
    (``g_ext<rank>``, ``g_all<rank>``)."""
    from surfacenetworks_tpu_torch import parallel_context
    from surfacenetworks_tpu_torch.dist.edge_partition import halo_exchange

    f = np.load(case["input"])
    g = mesh.graph_index
    x = _rows(f["x"], mesh).requires_grad_(True)
    ext = halo_exchange(x, int(f["halo"]), mesh.graph)
    ext.backward(torch.from_numpy(f[f"g_ext{g}"]))
    x_bar_ext = x.grad.clone()
    x.grad = None
    whole = parallel_context.gather_rows(x, mesh.graph)
    whole.backward(torch.from_numpy(f[f"g_all{g}"]))
    return {"ext": ext.detach().numpy(), "x_bar_ext": x_bar_ext.numpy(), "whole": whole.detach().numpy(),
            "x_bar_all": x.grad.numpy()}


_KINDS = {"pspmm": _pspmm, "layers": _layers, "dirac": _dirac, "gat": _gat, "exchange": _exchange}


def _rank(full_mesh, spec: dict, out_dir: str) -> None:
    import torch.distributed as dist

    rank = full_mesh.rank
    devices = ["cpu"] * full_mesh.size
    for case in spec["cases"]:
        nd, ng = case["n_data"], case["n_graph"]
        mesh = mesh_setup.make_mesh(nd, ng, devices)
        if mesh is not None and case.get("kind") in _KINDS:
            res = _KINDS[case["kind"]](case, mesh)
            np.savez(os.path.join(out_dir, f"{case['name']}_r{rank}.npz"), **res)
        elif mesh is not None:
            c = _Case(case, mesh if nd * ng > 1 else None)
            batch = c.local_batch()
            # a --bf16 model computes in bf16 whatever its parameters' dtype: its fp32 step alone
            dtypes = [(tag, dt) for tag, dt in (("64", torch.float64), ("32", torch.float32))
                      if tag in case.get("dtypes", ("64", "32"))]
            res = {}
            with _local_bn() if case.get("mutant") == "local_bn" else contextlib.nullcontext():
                for tag, dt in dtypes:
                    res.update({f"{k}{tag}": v for k, v in c.run(c.trainer.model, batch, c.mesh, dt).items()})
            if rank == 0:
                whole = c.whole_batch()
                ref = copy.deepcopy(c.trainer.model)
                for tag, dt in dtypes:
                    res.update({f"ref.{k}{tag}": v for k, v in c.run(ref, whole, None, dt).items()})
                if c.kind == "normal" and c.trainer.args.rotate_augment:
                    res["rotation"] = c.rotation(whole, None, torch.float32).numpy()
                res["names"] = np.asarray([str(s.get("name")) if isinstance(s, dict) else str(s)
                                           for s in c.samples])
                if c.kind == "correspondence":
                    res.update(target=c.trainer.pair_target(*c.samples[0][:2]).numpy(),
                               pair=np.asarray(c.samples[0][:2]), rots=np.asarray(c.samples[0][2]))
                elif c.kind in ("mnist", "vae"):
                    res["inputs"] = whole.inputs.numpy()
            np.savez(os.path.join(out_dir, f"{case['name']}_r{rank}.npz"), **res)
        dist.barrier()


def main() -> None:
    spec_path, out_dir = sys.argv[1], sys.argv[2]
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    mesh_setup.launch(_rank, 1, spec["ranks"], device="cpu", args=(spec, out_dir), timeout_s=spec.get("timeout", 120),
                      threads=1)


if __name__ == "__main__":
    main()
