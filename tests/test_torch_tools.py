"""The port's tools against the JAX package's contracts: ``train/timing.py``
(``time_string``, ``device_timer``, ``trace``, ``ThroughputMeter``; mirrors
``tests/test_timing.py``), ``train_normal --jax-profile``, the environment
line and parameter count every trainer logs, and ``LapDeepModel(remat=)``.

Remat recomputes each block in the backward: outputs and gradients equal
the plain model's bit for bit (batch norm on batch statistics, no random
draws).  Against the JAX package's ``LapDeepModel(remat=True)`` with the
same converted weights: outputs at ``tests/test_torch_nn.py``'s model bound
(1e-4 of ``max|ref|`` in fp32) and gradients in fp64 (JAX under
``enable_x64``) to 1e-6, the bound of the trainers' fp64 steps.
"""

import json
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surfacenetworks_tpu.models import normal_models as jmodels
from surfacenetworks_tpu_torch.cli import common
from surfacenetworks_tpu_torch.cli import train_normal as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.models import normal_models as tmodels
from surfacenetworks_tpu_torch.train import ThroughputMeter, device_timer, time_string, timing, trace

from torch_parity import assert_close, blob_laplacian, operators, perturbed_params, profile_flag_writes_trace, rcm, \
    to_jax

BLOCK_RTOL = 1e-4
FP64_RTOL = 1e-6
OBJS = __import__("pathlib").Path(__file__).parent / "fixtures" / "objs"


# ---------------------------------------------------------------------- timing


def test_time_string_format():
    assert re.fullmatch(r"\d{8}_\d{6}", time_string())


@pytest.mark.parametrize("how", ["box", "argument", "callable", "tree"])
def test_device_timer_syncs_and_reports(how):
    logs = []
    a = torch.ones(64, 64)
    sync = {"argument": a, "callable": lambda: a @ a, "tree": {"x": [a, (a,)]}}.get(how)
    with device_timer("spmm", sync=sync, log=logs.append) as box:
        if how == "box":
            box["sync"] = a @ a
    assert box["seconds"] > 0
    assert len(logs) == 1 and logs[0].startswith("[spmm]") and logs[0].endswith(" ms")


def test_device_timer_silent_without_name():
    with device_timer() as box:
        pass
    assert "seconds" in box


def test_synchronize_ignores_cpu_tensors_and_other_leaves():
    timing.synchronize([torch.ones(2), 3, "x", None, {"a": torch.zeros(1)}])


def test_throughput_meter():
    m = ThroughputMeter(edges_per_step=1000.0)
    m.step(5)
    m._t0 = time.perf_counter() - 1.0  # freeze elapsed ~1s for stable rates
    s = m.summary()
    assert s["steps"] == 5
    assert abs(m.steps_per_s - 5.0) < 0.1
    assert abs(m.edges_per_s - 5000.0) < 100.0
    m.reset()
    assert m.summary()["steps"] == 0


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(str(tmp_path / "prof")) as box:
        y = torch.ones(32, 32) @ torch.ones(32, 32)
    assert float(y[0, 0]) == 32.0
    data = json.loads(open(box["path"]).read())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names
    assert box["path"].startswith(str(tmp_path / "prof"))


# ----------------------------------------------------------------- --jax-profile


def test_jax_profile_traces_the_first_epoch(tmp_path):
    """One trace for two epochs, of the first one's updates: the model's
    operator applies are in it."""
    data = profile_flag_writes_trace(ttrain.main, ["--device", "cpu", "--data-path", str(OBJS), "--layer", "2",
                                                   "--num-epoch", "2", "--num-updates", "2", "--batch-size", "2",
                                                   "--operator-format", "ell"], tmp_path)
    names = [e.get("name", "") for e in data["traceEvents"]]
    assert any("_EllApply" in n for n in names), sorted(set(names))[:40]


def test_jax_profile_skipped_under_only_forward_test(tmp_path):
    ttrain.main(["--device", "cpu", "--data-path", str(OBJS), "--layer", "2", "--num-epoch", "1", "--batch-size", "2",
                 "--only-forward-test", "--result-dir", str(tmp_path / "run"), "--jax-profile", str(tmp_path / "p")])
    assert not (tmp_path / "p").exists()
    assert "profiler trace" not in (tmp_path / "run" / "log" / "debug.log").read_text()


# ----------------------------------------------------- environment and params


def test_log_environment_and_count_params():
    lines = []
    common.log_environment(lines.append, torch.device("cpu"))
    assert lines[0].startswith("hostname ")
    assert lines[1].startswith(f"devices torch {torch.__version__}, CUDA {torch.version.cuda}, device cpu, ")
    model = tmodels.LapDeepModel(3, 3, layers=2)
    assert common.count_params(model) == sum(p.numel() for p in model.parameters()) > 0


@pytest.mark.parametrize("trainer", ["normal", "mnist", "vae", "arap", "correspondence"])
def test_trainers_log_environment_and_parameters(tmp_path, trainer):
    """Every trainer logs the environment line and ``Num parameters`` at
    its start."""
    from surfacenetworks_tpu_torch.cli import train_arap, train_correspondence, train_mnist, train_vae

    fixtures = OBJS.parent
    main, argv, log = {
        "normal": (ttrain.main, ["--data-path", str(OBJS), "--layer", "2", "--num-updates", "1", "--batch-size", "2"],
                   "debug.log"),
        "mnist": (train_mnist.main, ["--data-path", str(fixtures / "mnist_plus.np"), "--layer", "2",
                                     "--batch-size", "4"], "mnist.log"),
        "vae": (train_vae.main, ["--data-path", str(fixtures / "mnist_plus.np"), "--num-layers", "2",
                                 "--batch-size", "4"], "vae.log"),
        "arap": (train_arap.main, ["--data-path", str(fixtures / "arap"), "--layer", "2", "--num-updates", "1",
                                   "--batch-size", "2"], "test.log"),
        "correspondence": (train_correspondence.main, ["--datapath", str(fixtures / "faust"), "--layer", "2",
                                                       "--num-updates", "1"], "test.log"),
    }[trainer]
    main(["--device", "cpu", "--num-epoch", "1", "--result-dir", str(tmp_path), *argv])
    text = (tmp_path / "log" / log).read_text()
    assert re.search(r"^hostname \S+", text, re.M)
    assert re.search(r"^devices torch \S+, CUDA \S+, device cpu, \d+ CUDA devices?$", text, re.M)
    assert re.search(r"^Num parameters \d+$", text, re.M)


# ----------------------------------------------------------------------- remat


def _lap_pair(fmt, seed=9):
    n_points, N = 200, 256
    _, _, L = blob_laplacian(7, n_points)
    L = rcm(L) if fmt == "bsr" else L
    jop, top = operators(L, N, fmt, batch=2)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, N, 3)).astype(np.float32)
    mask = np.ones((2, N, 1), np.float32)
    mask[:, n_points:] = 0.0
    x[:, n_points:] = 0.0
    cot = rng.normal(size=(2, N, 3)).astype(np.float32)
    return jop, top, x, mask, cot


def _port_run(model, op, x, mask, cot, dtype=torch.float32):
    model.zero_grad(set_to_none=True)
    out = model(op, torch.from_numpy(mask).to(dtype), torch.from_numpy(x).to(dtype))
    (out * torch.from_numpy(cot).to(dtype)).sum().backward()
    return out.detach(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("fmt", ["ell", "bsr", "dense"])
def test_remat_is_bit_identical(fmt):
    _, top, x, mask, cot = _lap_pair(fmt)
    plain = tmodels.LapDeepModel(3, 3, layers=3)
    torch.manual_seed(0)
    for p in plain.parameters():
        p.data.normal_(0.0, 0.3)
    remat = tmodels.LapDeepModel(3, 3, layers=3, remat=True)
    remat.load_state_dict(plain.state_dict())
    out0, g0 = _port_run(plain, top, x, mask, cot)
    out1, g1 = _port_run(remat, top, x, mask, cot)
    assert torch.equal(out0, out1)
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(bool((g != 0).any()) for g in g1.values())


def test_remat_matches_jax_remat_model():
    jop, top, x, mask, cot = _lap_pair("ell")
    jmod = jmodels.LapDeepModel(3, 3, layers=3, remat=True)
    tmod = tmodels.LapDeepModel(3, 3, layers=3, remat=True)
    jm, jx = jnp.asarray(mask), jnp.asarray(x)
    params = perturbed_params(jmod.init(jax.random.key(0), jop, jm, jx)["params"], 9)
    tmod.load_state_dict(params_from_flax(params, like=tmod), strict=True)
    out, _ = _port_run(tmod, top, x, mask, cot)
    assert_close(out.numpy(), np.asarray(jmod.apply({"params": to_jax(params)}, jop, jm, jx)), BLOCK_RTOL, "remat fp32")

    # gradients in fp64 on the dense operator (the ELL apply's plain version is fp32)
    jdense, tdense, *_ = _lap_pair("dense")
    model64 = tmodels.LapDeepModel(3, 3, layers=3, remat=True)
    model64.load_state_dict(params_from_flax(params, like=model64), strict=True)
    model64.double()
    _, g64 = _port_run(model64, tdense.double(), x, mask, cot, torch.float64)
    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)

        def objective(q):
            out = jmod.apply({"params": q}, jnp.asarray(jdense, jnp.float64), jnp.asarray(mask, jnp.float64),
                             jnp.asarray(x, jnp.float64))
            return (out * jnp.asarray(cot, jnp.float64)).sum()

        jg = jax.grad(objective)(jp64)
        jg = params_from_flax(jax.tree_util.tree_map(np.asarray, jg), like=model64)
    for k, g in g64.items():
        assert_close(g.numpy(), jg[k].numpy(), FP64_RTOL, f"fp64 grad {k}")
