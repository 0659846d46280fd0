"""``train_correspondence --multihost`` on the CPU: two processes started
apart meet over gloo at a coordinator on ``127.0.0.1``
(``tests/test_torch_multihost.py``'s helpers).

* ``--graph-parallel 4 --loss sl1`` (two local ranks a process) on
  synthetic scans at 2 layers equals the one-launch run bit for bit: the
  checkpoint's parameters and optimizer state and the metrics lines (the
  throughput aside).  Both take the host path.
* With dcel the two processes take the host path (as the JAX trainer, whose
  fast path needs one process) and the one-launch run the fast path, so
  they agree by the sharded steps' fp32 rules: the loss within 3e-5 relative, the
  parameters within 2 lr + 1e-7 (a flipped first Adam step moves an element
  by exactly 2 lr).
* ``--smooth-reg`` with ``--multihost`` gets the JAX trainer's message.
"""

import pytest
import torch

from test_torch_multihost import CKPT, FAUST, FP32_LOSS, FP32_PARAM, _bit_for_bit, _launches, _metrics


def test_two_processes_equal_one_launch_sl1(tmp_path):
    """The graph axis spread over two launches is the one-launch axis: the
    same ranks, pairs and collectives, so the same bits."""
    _bit_for_bit("train_correspondence", *_launches("train_correspondence", FAUST + ["--loss", "sl1"], tmp_path))
    assert "multihost: process 0/2, 4 global devices (2 local)" in (tmp_path / "two" / "log" / "test.log").read_text()


def test_faust_dcel_host_path_against_fast_path(tmp_path):
    """dcel under ``--multihost`` trains on the host path (the log says so)
    and agrees with the one-launch fast path by the sharded steps' fp32 rules."""
    _launches("train_correspondence", FAUST + ["--loss", "dcel"], tmp_path)
    assert "host path: geodesic matrices stay on host (--multihost)" in (tmp_path / "two" / "log" / "test.log").read_text()
    one, two = _metrics("train_correspondence", tmp_path / "one"), _metrics("train_correspondence", tmp_path / "two")
    assert [r["split"] for r in one] == [r["split"] for r in two]
    for a, b in zip(one, two):
        assert abs(a["loss"] - b["loss"]) <= FP32_LOSS * abs(a["loss"]), (a, b)
    sa, sb = (torch.load(d / CKPT["train_correspondence"], weights_only=True)["params"] for d in
              (tmp_path / "one", tmp_path / "two"))
    for k in sa:
        err = float((sa[k] - sb[k]).abs().max())
        assert err <= FP32_PARAM, (k, err)


def test_smooth_reg_with_multihost_is_refused():
    """JAX's message: the smoothness term needs the single-device fast path."""
    from surfacenetworks_tpu_torch.cli import train_correspondence as ttrain

    with pytest.raises(SystemExit, match=r"--smooth-reg requires the single-device fast path \(no --graph-parallel / "
                                         r"--multihost\)"):
        ttrain.main(["--multihost", "--smooth-reg", "0.1", "--device", "cpu"])
    assert ttrain.refuse_unported(ttrain.parser.parse_args(["--multihost"])) is None
