"""The port's checkpoint module against the JAX package's on the CPU: the
flax-msgpack reader against ``flax.serialization.msgpack_restore``; a JAX
``save_checkpoint`` file restored into the port after k optax steps, whose
next port step must equal optax's next step, for each optax state tree the
JAX package's trainers write; ``fuzzy_restore``; the port's own checkpoints;
and the FAUST trainer's ``--deser-option``.

Tolerance of a step after a restore: 1e-6 of ``max|ref|`` (fp32, optax's
arithmetic in another order: a few ulps)."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from surfacenetworks_tpu.models import normal_models as jmodels
from surfacenetworks_tpu.train import checkpoint as jckpt
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch.cli import train_correspondence as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.models import LapDeepModel
from surfacenetworks_tpu_torch.train import checkpoint, optim

from torch_parity import assert_close, perturbed_params, to_jax

STEP_RTOL = 1e-6
FAUST = pathlib.Path(__file__).parent / "fixtures" / "faust"


def _lap_params(seed: int = 0) -> dict:
    """Perturbed flax params of LapDeepModel(3, 3, layers=2) (numpy tree)."""
    N = 16
    op = jnp.asarray(np.eye(N, dtype=np.float32)[None])
    mask, x = jnp.ones((1, N, 1)), jnp.ones((1, N, 3))
    return perturbed_params(jmodels.LapDeepModel(3, 3, layers=2).init(jax.random.key(0), op, mask, x)["params"], seed)


def _grads(params, k: int) -> list:
    rng = np.random.default_rng(100 + k)
    return [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32) * (3.0 if i % 2 else 0.1),
                                   params) for i in range(k)]


def _case(kind):
    """(optax transformation, port optimizer factory) of one trainer's recipe."""
    sched = joptim.epoch_halving_schedule(1e-2, 5, 0, 1)
    port_sched = optim.epoch_halving_schedule(1e-2, 5, 0, 1)
    return {
        "adam": (joptim.adam(1e-2), lambda p: optim.adam(p, 1e-2)),
        "amsgrad": (joptim.adam(1e-2, amsgrad=True), lambda p: optim.adam(p, 1e-2, amsgrad=True)),
        "sgd": (joptim.sgd(1e-2), lambda p: optim.sgd(p, 1e-2)),
        "faust_adam_wd": (joptim.adam(1e-2, weight_decay=1e-5), lambda p: optim.adam(p, 1e-2, weight_decay=1e-5)),
        "adam_half_lr": (joptim.adam(sched), lambda p: optim.adam(p, port_sched)),
    }[kind], (port_sched if kind == "adam_half_lr" else None)


@pytest.mark.parametrize("kind", ["adam", "amsgrad", "sgd", "faust_adam_wd", "adam_half_lr"])
def test_jax_checkpoint_resumes_in_the_port(kind, tmp_path):
    """k = 5 optax steps, ``save_checkpoint`` by the JAX package, then
    ``restore_training`` into a fresh port model and optimizer: the params,
    epoch and step come back, the optimizer state loads, and one more port
    step on the same gradient equals optax's 6th step.  ``adam_half_lr``
    crosses a halving boundary (5 steps per epoch, halving every epoch) at
    the resumed step, so the schedule's count must come from the file."""
    (tx, make_opt), schedule = _case(kind)
    params = to_jax(_lap_params())
    state = tx.init(params)
    grads = _grads(params, 6)
    for g in grads[:5]:
        upd, state = tx.update(to_jax(g), state, params)
        params = optax.apply_updates(params, upd)
    path = str(tmp_path / "ckpt.msgpack")
    jckpt.save_checkpoint(path, params, state, epoch=3, step=5)
    upd, _ = tx.update(to_jax(grads[5]), state, params)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, optax.apply_updates(params, upd)))

    model = LapDeepModel(3, 3, layers=2)
    opt = make_opt(model.parameters())
    epoch, step, loaded = checkpoint.restore_training(path, model, opt)
    assert (epoch, step, loaded) == (3, 5, True)
    saved = params_from_flax(jax.tree_util.tree_map(np.asarray, params), like=model)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved[k].numpy(), err_msg=k)
    g5 = params_from_flax(grads[5], like=model)
    for k, p in model.named_parameters():
        p.grad = g5[k].clone()
    optim.apply_schedule(opt, schedule)
    opt.step()
    for k, p in model.named_parameters():
        assert_close(p.detach().numpy(), want[k].numpy(), STEP_RTOL, f"{kind} {k}")


@pytest.mark.parametrize("payload", ["checkpoint", "scalars"])
def test_msgpack_reader_matches_flax(payload, tmp_path):
    """The pure-Python reader gives what ``msgpack_restore`` gives: the same
    keys, values, dtypes and shapes."""
    if payload == "checkpoint":
        params = to_jax(_lap_params(3))
        state = joptim.adam(1e-3, weight_decay=1e-5).init(params)
        path = str(tmp_path / "c.msgpack")
        jckpt.save_checkpoint(path, params, state, epoch=7, step=123456)
        data = pathlib.Path(path).read_bytes()
    else:
        tree = {"i8": 5, "neg": -33, "big": 2**40, "nbig": -(2**40), "f": 0.1, "t": True, "n": None,
                "s": "x" * 40, "long": "y" * 300, "np_f32": np.float32(2.5), "np_i64": np.int64(-7),
                "arrays": {str(i): (np.arange(i * 5) % 3).astype(dt).reshape(i, 5)
                           for i, dt in enumerate([np.float32, np.float64, np.int32, np.int64, np.uint8, np.bool_])},
                "many": {f"k{i}": i for i in range(20)}}
        data = serialization.msgpack_serialize(tree)
    ref = serialization.msgpack_restore(data)
    got = checkpoint.decode_flax_msgpack(data)

    def same(a, b, where="") -> None:
        assert type(a) is type(b), (where, type(a), type(b))
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), where
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, (np.ndarray, np.generic)):
            assert a.dtype == b.dtype and np.shape(a) == np.shape(b), where
            np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            assert a == b, where

    same(got, ref)


@pytest.mark.parametrize("case", ["chunked", "complex", "int_key", "trailing"])
def test_msgpack_reader_refuses_what_flax_checkpoints_do_not_hold(case):
    import msgpack

    if case == "chunked":
        data = msgpack.packb({"a": {"__msgpack_chunked_array__": True, "shape": [2]}})
    elif case == "complex":
        data = serialization.msgpack_serialize({"c": 1 + 2j})
    elif case == "int_key":
        data = msgpack.packb({1: 2})
    else:
        data = serialization.msgpack_serialize({"a": 1}) + b"\x00"
    with pytest.raises(ValueError, match="msgpack"):
        checkpoint.decode_flax_msgpack(data)


def test_fuzzy_restore_keeps_init_for_missing_and_mismatched_keys(tmp_path):
    """A key missing from the file and a key of another shape keep their
    initialised values; every other parameter is loaded; a file without
    ``step`` restores step 0 and one without optimizer state loads none."""
    model = LapDeepModel(3, 3, layers=2)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    params = _lap_params(5)
    del params["conv2"]["fc"]["bias"]
    params["conv1"]["fc"]["kernel"] = np.ones((5, 128), np.float32)  # Dense(3 -> 128) expects [3, 128]
    path = str(tmp_path / "p.msgpack")
    with open(path, "wb") as fh:
        fh.write(serialization.msgpack_serialize({"params": params, "epoch": np.asarray(2)}))
    opt = optim.adam(model.parameters(), 1e-3)
    assert checkpoint.restore_training(path, model, opt) == (2, 0, False)
    kept = {"conv1.fc.weight", "conv2.fc.bias"}
    loaded = params_from_flax(_lap_params(5))
    for k, v in model.state_dict().items():
        ref = init[k] if k in kept else loaded[k]
        np.testing.assert_array_equal(v.numpy(), ref.numpy(), err_msg=k)


def test_port_checkpoint_roundtrip_and_optimizer_fit(tmp_path):
    """``save_checkpoint`` then ``restore_training``: params, Adam state,
    epoch and step come back; the same file into an SGD optimizer, or into
    a scheduled Adam, leaves the optimizer as it was."""
    torch.manual_seed(0)
    model = LapDeepModel(3, 3, layers=2)
    opt = optim.adam(model.parameters(), 1e-3)
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    opt.step()
    path = str(tmp_path / "s.pt")
    checkpoint.save_checkpoint(path, model, opt, epoch=4, step=9)
    fresh = LapDeepModel(3, 3, layers=2)
    fopt = optim.adam(fresh.parameters(), 1e-3)
    assert checkpoint.restore_training(path, fresh, fopt) == (4, 9, True)
    for (k, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=k)
    assert all(torch.equal(opt.state[p]["exp_avg_sq"], fopt.state[q]["exp_avg_sq"])
               for p, q in zip(model.parameters(), fresh.parameters()))
    for other in (optim.sgd(fresh.parameters(), 1e-3),
                  optim.adam(fresh.parameters(), optim.epoch_halving_schedule(1e-3, 5, 0, 1))):
        assert checkpoint.restore_training(path, fresh, other) == (4, 9, False)
        assert not other.state


def test_check_finite():
    checkpoint.check_finite({"loss": 1.0, "mad": torch.tensor([0.5, 2.0])})
    with pytest.raises(FloatingPointError, match="loss"):
        checkpoint.check_finite({"loss": float("nan")}, "at epoch 3")


def _faust(tmp_path, *extra):
    return ttrain.main(["--datapath", str(FAUST), "--device", "cpu", "--layer", "2", "--num-updates", "1",
                        "--num-epoch", "1", "--result-dir", str(tmp_path), *extra])


@pytest.mark.parametrize("option", ["auto", "force", "no"])
def test_faust_trainer_deser_option(option, tmp_path):
    """The FAUST trainer saves ``pts/<prefix>_state.pt`` at the end; a second
    run resumes from it under ``auto`` (the default) and ``force``, and not
    under ``no``: the resumed run's first loss is the first run's model's."""
    _faust(tmp_path)
    ckpt = tmp_path / "pts" / "test_state.pt"
    assert ckpt.is_file()
    saved = torch.load(ckpt, weights_only=True)
    assert saved["step"] == 1 and saved["epoch"] == 0
    _faust(tmp_path, "--deser-option", option)
    log = (tmp_path / "log" / "test.log").read_text()
    assert log.count("Continue...") == (0 if option == "no" else 1)
    after = torch.load(ckpt, weights_only=True)
    assert after["step"] == (1 if option == "no" else 2)
