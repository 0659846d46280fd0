"""Export a normal-prediction model to a serving artifact (counterpart of
``surfacenetworks_tpu/cli/export_model.py``, with its flags).

Restores a checkpoint (the port's ``.pt`` or the JAX package's
``.msgpack``, by ``fuzzy_restore``), builds the operator of the target mesh
(or of a synthetic 120-vertex stand-in) and writes one ``torch.export``
artifact (``serve.export_forward``) of the Lap model over the ELL operator
(``laplacian_batch``'s default format: the artifact calls ``ell_matmul``)
or of the Dirac model over the structured Dirac tables.  It is exported for
the card unless ``--platforms cpu``::

    python -m surfacenetworks_tpu_torch.cli.export_model \\
        --model lap --layer 15 --deser results/normal_predict/pts/run.msgpack \\
        --mesh path/to/scan.obj --out model.snx
    python -m surfacenetworks_tpu_torch.cli.export_model --synthetic --model dirac \\
        --platforms cpu --out /tmp/m.snx
"""

from __future__ import annotations

import argparse

import torch

from surfacenetworks_tpu_torch import serve
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.data import Buckets, datasets, dirac_batch, laplacian_batch
from surfacenetworks_tpu_torch.models import DirDeepModel, LapDeepModel, init_weights
from surfacenetworks_tpu_torch.train import checkpoint

parser = argparse.ArgumentParser(description="Export model for serving (PyTorch)")
parser.add_argument("--model", default="lap", help="lap | dirac")
parser.add_argument("--layer", type=int, default=15)
parser.add_argument("--deser", default=None, help="checkpoint to restore (.pt or msgpack)")
parser.add_argument("--mesh", default=None, help=".obj/.ply mesh fixing the served bucket")
parser.add_argument("--synthetic", action="store_true", help="synthetic mesh (smoke test)")
parser.add_argument("--bucket", type=int, default=0, help="vertex bucket override (0 = mesh size)")
parser.add_argument("--bf16", action="store_true", help="bf16 compute in the artifact")
parser.add_argument("--runtime-operator", action="store_true",
                    help="keep the operator a runtime argument (one artifact, many same-bucket meshes) instead of "
                         "baking it in")
parser.add_argument("--platforms", nargs="+", default=["cuda"], help="cuda (default) or cpu: one device")
parser.add_argument("--out", required=True)


def main(argv=None) -> dict:
    """Write the artifact; returns its ``export_info``."""
    args = parser.parse_args(argv)
    operator = "dirac" if args.model.startswith("dirac") else "lap"
    if args.synthetic or args.mesh is None:
        samples = datasets.synthetic_normal_dataset(1, 120, seed=0, operator=operator)
    else:
        sample = datasets.load_normal_sample(args.mesh, operator=operator)
        if sample is None:
            raise SystemExit(
                f"--mesh {args.mesh}: empty or degenerate mesh (no faces, NaN "
                "normals, or non-finite operator entries) — cannot export"
            )
        samples = [sample]
    buckets = Buckets.for_samples(samples)
    if args.bucket:
        buckets.n_vertices = max(buckets.n_vertices, args.bucket)
    batch = (dirac_batch if operator == "dirac" else laplacian_batch)(samples, buckets)

    dt = torch.bfloat16 if args.bf16 else None
    if operator == "dirac":
        model = DirDeepModel(3, 3, args.layer, dtype=dt)
    else:
        model = LapDeepModel(3, 3, layers=args.layer, dtype=dt)
    init_weights(model, torch.Generator().manual_seed(0))
    if args.deser:
        ckpt = checkpoint.load_checkpoint(args.deser)
        checkpoint.fuzzy_restore(model, params_from_flax(ckpt["params"]) if ckpt["format"] == "flax"
                                 else ckpt["params"])

    blob = serve.export_forward(model, None, batch.operator, batch.mask, batch.inputs,
                                bake_operator=not args.runtime_operator, platforms=tuple(args.platforms))
    with open(args.out, "wb") as f:
        f.write(blob)
    info = serve.export_info(blob)
    print(f"wrote {args.out}: {len(blob)} bytes, platforms={info['platforms']}, "
          f"in={info['in_avals']}, out={info['out_avals']}")
    return info


if __name__ == "__main__":
    main()
