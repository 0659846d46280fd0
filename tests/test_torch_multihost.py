"""``--multihost`` on the CPU: two processes started apart, as JAX's
``tests/_multihost_trainer_worker.py`` starts them, meeting over gloo at a
coordinator on ``127.0.0.1`` (the FAUST trainer's runs are in
``tests/test_torch_multihost_faust.py``, which shares the helpers here).

* ``train_normal --data-parallel 4`` (two local ranks a process) and
  ``train_normal --graph-parallel 2`` (one a process) on synthetic data at
  2 layers equal the one-launch run of the same flags bit for bit: the
  checkpoint's parameters and optimizer state and the metrics lines (the
  throughput aside).  CPU ranks take the machine's cores over the grid's
  ranks, however many launches start them, so the sums match too.
* ``--multihost`` alone trains a replica on each process, process 0
  writing: its checkpoint equals the one-process run's bit for bit.
* Refusals: an unreachable coordinator raises within the timeout; a grid the
  processes do not divide, ``--multihost`` with neither the coordinator
  flags nor torchrun's environment, a partial set of flags and an address
  without a port are refused.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import time

import pytest
import torch

from surfacenetworks_tpu_torch.dist import mesh_setup

REPO = pathlib.Path(__file__).resolve().parents[1]
RUN_TIMEOUT_S = 120
LR = 1e-3
FP32_LOSS, FP32_PARAM = 3e-5, 2 * LR + 1e-7

NORMAL = ["--device", "cpu", "--synthetic", "8", "--batch-size", "4", "--layer", "2", "--num-epoch", "1",
          "--num-updates", "2"]
FAUST = ["--device", "cpu", "--synthetic", "3", "--layer", "2", "--num-epoch", "1", "--num-updates", "2",
         "--deser-option", "no", "--graph-parallel", "4"]
CKPT = {"train_normal": "pts/debug_normal_state.pt", "train_correspondence": "pts/test_state.pt"}
METRICS = {"train_normal": "log/debug.metrics.jsonl", "train_correspondence": "log/test.metrics.jsonl"}


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT", "RANK",
                                                            "WORLD_SIZE")}
    env["PYTHONPATH"] = str(REPO)
    return env


def _run(procs: list) -> None:
    """Wait for ``procs`` (their own sessions) under one timeout; kill them
    all on expiry; every one must exit 0."""
    deadline = time.monotonic() + RUN_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            os.killpg(p.pid, signal.SIGKILL)
        raise AssertionError(f"the processes did not finish in {RUN_TIMEOUT_S} s")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-6000:]


def _start(trainer: str, flags: list, out: pathlib.Path, extra: list) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", f"surfacenetworks_tpu_torch.cli.{trainer}", *flags,
                             "--result-dir", str(out), *extra], cwd=out.parent, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)


def _launches(trainer: str, flags: list, tmp: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path]:
    """The one-launch run (``tmp/one``) and the two-process ``--multihost``
    run (``tmp/two``) of ``flags``, all three processes at once."""
    one, two = tmp / "one", tmp / "two"
    one.mkdir()
    two.mkdir()
    coord = ["--multihost", "--coordinator-address", f"127.0.0.1:{mesh_setup.free_port()}", "--num-processes", "2"]
    _run([_start(trainer, flags, one, [])] + [_start(trainer, flags, two, coord + ["--process-id", str(i)])
                                             for i in range(2)])
    return one, two


def _tensors(obj, prefix=""):
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_tensors(v, f"{prefix}/{k}"))
        return out
    return {prefix: torch.tensor(float(obj))} if isinstance(obj, (int, float)) else {}


def _state(trainer: str, out: pathlib.Path) -> dict:
    return _tensors(torch.load(out / CKPT[trainer], weights_only=True))


def _metrics(trainer: str, out: pathlib.Path) -> list:
    lines = [json.loads(line) for line in (out / METRICS[trainer]).read_text().splitlines()]
    return [{k: v for k, v in r.items() if k not in ("time", "steps_per_s")} for r in lines]


def _bit_for_bit(trainer: str, a: pathlib.Path, b: pathlib.Path) -> None:
    sa, sb = _state(trainer, a), _state(trainer, b)
    assert sa.keys() == sb.keys() and len(sa) > 10
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert _metrics(trainer, a) == _metrics(trainer, b)


CASES = {
    "normal_dp4": ("train_normal", NORMAL + ["--data-parallel", "4"]),
    "normal_gp2": ("train_normal", NORMAL + ["--graph-parallel", "2"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_processes_equal_one_launch(case, tmp_path):
    """The grid spread over two launches is the one-launch grid: the same
    ranks, batches and collectives, so the same bits; process 0 logs JAX's
    multihost line."""
    trainer, flags = CASES[case]
    _bit_for_bit(trainer, *_launches(trainer, flags, tmp_path))
    prefix = "debug" if trainer == "train_normal" else "test"
    ranks = 4 if case != "normal_gp2" else 2
    assert (f"multihost: process 0/2, {ranks} global devices ({ranks // 2} local)"
            in (tmp_path / "two" / "log" / f"{prefix}.log").read_text())


def test_multihost_alone_trains_replicas(tmp_path):
    """Without a grid axis every process trains the whole run on its own
    device and process 0 writes, as the JAX trainer's processes do."""
    _bit_for_bit("train_normal", *_launches("train_normal", NORMAL, tmp_path))
    assert "multihost: process 0/2, 2 global devices (1 local)" in (tmp_path / "two" / "log" / "debug.log").read_text()


def _never_called(mesh):
    raise AssertionError("no rank may start")


def test_unreachable_coordinator_raises_within_the_timeout():
    """Process 1 with nobody at the coordinator: the rendezvous raises
    within its timeout (never a run of one process)."""
    t0 = time.monotonic()
    with pytest.raises(Exception) as err:
        mesh_setup.launch_multihost(_never_called, 2, 1, f"127.0.0.1:{mesh_setup.free_port()}", 2, 1, device="cpu",
                                    timeout_s=3)
    assert not isinstance(err.value, AssertionError)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("how", ["indivisible", "no flags", "some flags", "bad address"])
def test_multihost_refusals(how, monkeypatch):
    """A grid the processes do not divide, no coordinator flags and no
    torchrun environment, a partial set of flags and an address without a
    port are refused before any rank starts."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    args, msg = {"indivisible": ((3, 1, "127.0.0.1:1", 2, 0), "does not divide over 2 processes"),
                 "no flags": ((2, 1, None, None, None), "torchrun's environment"),
                 "some flags": ((2, 1, "127.0.0.1:1", 2, None), "needs all of"),
                 "bad address": ((2, 1, "127.0.0.1", 2, 0), "is not host:port")}[how]
    with pytest.raises(SystemExit, match=msg):
        mesh_setup.launch_multihost(_never_called, *args, device="cpu", timeout_s=3)
