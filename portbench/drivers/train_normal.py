"""The system under test for the normal-prediction cells: the port's
``cli/train_normal.py::NormalTrainer``, built from the trainer's own parser
as a user's run builds it (the configuration's preset and depth, ``--data-path`` on
the benchmark's ``.obj`` files, ``--seed``, ``--device``, the traffic's
flags; every other flag at its default, ``--operator-format auto`` among
them), and driven by the trainer's own loop: ``train_batches(n)``, then
``update(batch)`` for each batch.
"""

from __future__ import annotations

import os

from portbench import meshes as mesh_gen


class Session:
    """One trainer over the meshes of one run.  ``meshes`` are the float64
    ``(V, F)`` the benchmark generated (train meshes first); ``index`` maps
    a file name the program reports in a batch to its mesh."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str, workdir: str, log):
        from surfacenetworks_tpu_torch import config as port_config
        from surfacenetworks_tpu_torch.cli import train_normal

        n_train, n_test, n_points = traffic["train_meshes"], traffic["test_meshes"], traffic["vertices"]
        self.meshes = mesh_gen.make_meshes(seed, n_train + n_test, n_points)
        data_dir = os.path.join(workdir, "train")
        argv = ["--preset", config["preset"], "--layer", str(config["layers"]), "--data-path", data_dir,
                "--seed", str(seed), "--device", device]
        if traffic["test_path"]:
            test_dir = os.path.join(workdir, "test")
            paths = mesh_gen.write_meshes(data_dir, self.meshes[:n_train], "train")
            paths.update({p: n_train + i for p, i in mesh_gen.write_meshes(test_dir, self.meshes[n_train:],
                                                                           "test").items()})
            argv += ["--test-path", test_dir]
        else:  # the trainer's own split of one folder
            paths = mesh_gen.write_meshes(data_dir, self.meshes, "mesh")
        self.index = {os.path.abspath(p): i for p, i in paths.items()}
        self.args = port_config.parse_with_config(train_normal.parser, argv + list(traffic["flags"]))
        self.trainer = train_normal.NormalTrainer(self.args, log)
        self.model, self.opt = self.trainer.model, self.trainer.opt
        self.lr = self.args.lr

    def batches(self, n: int):
        return self.trainer.train_batches(n)

    def update(self, batch):
        """One update; returns its loss, on the device."""
        return self.trainer.update(batch)[0]

    def mesh_indices(self, batch) -> list[int]:
        """The benchmark's meshes that a batch holds, in its order."""
        return [self.index[os.path.abspath(str(n))] for n in batch.names]

    @staticmethod
    def padded_sizes(batch) -> tuple[int, int]:
        """The rows (and faces) each mesh of a batch is padded to: the
        batch's shapes, which decide what the batch norms average over."""
        faces = getattr(batch.operator, "faces", None)
        return batch.inputs.shape[-2], (faces.shape[-2] if faces is not None else 0)

    def close(self) -> None:
        del self.trainer, self.model, self.opt
