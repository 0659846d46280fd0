"""The trainer's ``--model avg|mlp|id|gat`` step against the JAX package's,
and the ``--bf16`` GAT and Id models unit by unit.  Moved from
``tests/test_torch_normal_zoo.py``, whose module docstring states the
method and the tolerances and whose helpers these tests share, so the
suite's files balance across workers."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from surfacenetworks_tpu.cli import train_normal as jtrain
from surfacenetworks_tpu.cli.common import EpochSampler as JEpochSampler
from surfacenetworks_tpu.data import batching as jbat
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch.cli import train_normal as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax
from surfacenetworks_tpu_torch.train import losses as tlosses
from surfacenetworks_tpu_torch.train import optim as toptim

from test_torch_normal_zoo import (ADAM_ATOL, FP32_RATIO, FP64_RTOL, JMODELS, NULL_FP32, STEP_RTOL, TMODELS, _argv,
                                   _dense, _fro, _gather_form, _jax_run, _null_grads)
from torch_parity import BF16, assert_close, bf16_mesh, hold_bf16_model, hold_grads, operators, perturbed_params, to_jax


@pytest.mark.parametrize("model", sorted(JMODELS))
def test_model_step_matches_jax(model, tmp_path):
    """The trainer with ``--model <model>`` on the fixture meshes (2 layers,
    batch 2, the default format: ELL over RCM order for gat, dense per
    sample for the others):

    * the split and six batches' order equal the JAX trainer's name for
      name, and the first batch's inputs, targets and mask equal the JAX
      package's packing (gat's ELL operator, forward and stored transpose,
      the same matrices);
    * fp64, both packages (JAX under ``enable_x64``), the flax params moved
      off init by seeded noise and converted in: the loss, every gradient
      (null ones within 1e-12 of the largest) and the parameters after one
      Adam update (against optax) agree to 1e-6;
    * fp32, the trainer's own ``update``: the loss within 1e-4 of JAX's fp32
      loss; each gradient no farther (relative Frobenius) from the fp64 step
      than FP32_RATIO x JAX's own fp32 distance from it, plus 1e-6 (a null
      one within 1e-4 of the largest gradient); the parameters after the update equal
      optax's Adam applied to the port's gradients (3e-7 absolute)."""
    trainer = ttrain.NormalTrainer(ttrain.parser.parse_args(_argv(model, tmp_path, "--device", "cpu")),
                                   log=lambda _: None)
    jargs, jtrain_s, jtest_s, jbuckets = _jax_run(model, tmp_path)
    assert trainer.fmt == ("ell" if model == "gat" else "dense")
    assert isinstance(trainer.model, TMODELS[model])
    names = lambda ss: [s["name"] for s in ss]  # noqa: E731
    assert names(trainer.train_samples) == names(jtrain_s) and names(trainer.test_samples) == names(jtest_s)
    jsampler = JEpochSampler(jtrain_s, 2, seed=17)
    assert [names(trainer.train_sampler.next_batch()) for _ in range(6)] == [names(jsampler.next_batch())
                                                                              for _ in range(6)]
    trainer.train_sampler = ttrain.EpochSampler(trainer.train_samples, 2, seed=17)
    samples = trainer.train_sampler.next_batch()
    batch = trainer.batch(samples)
    by_name = {s["name"]: s for s in jtrain_s}
    jb = jbat.laplacian_batch([by_name[n] for n in names(samples)], jbuckets, fmt=trainer.fmt)
    for k in ("inputs", "targets", "mask"):
        np.testing.assert_array_equal(getattr(batch, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)
    if model == "gat":
        # the same matrices; the slots of a row may lie in another order (the JAX package's native packer keeps
        # the RCM-permuted CSR's order, the port packs as its NumPy packer does, in sorted column order)
        for part in ("fwd", "bwd"):
            t, j = getattr(batch.operator, part), getattr(jb.operator, part)
            np.testing.assert_array_equal(_dense(t.cols.numpy(), t.vals.numpy()),
                                          _dense(np.asarray(j.cols), np.asarray(j.vals)))

    jmodel = jtrain.build_model(jargs)
    assert isinstance(jmodel, JMODELS[model])
    jop = jax.tree_util.tree_map(jnp.asarray, jb.operator)
    params = perturbed_params(jmodel.init(jax.random.key(0), jop, jnp.asarray(jb.mask),
                                          jnp.asarray(jb.inputs))["params"], 31)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    model64 = copy.deepcopy(trainer.model).double()
    null = _null_grads(model)

    def jrun(p, dtype):
        op = jop if dtype == jnp.float32 or model != "gat" else _gather_form(jop)

        def objective(q):
            out = jmodel.apply({"params": q}, op, jnp.asarray(jb.mask, dtype), jnp.asarray(jb.inputs, dtype))
            return jlosses.normal_cosine_loss(out, jnp.asarray(jb.mask, dtype), jnp.asarray(jb.targets, dtype))
        return jax.value_and_grad(objective)(p)

    def as_state(tree):
        return {k: v.double().numpy() for k, v in params_from_flax(jax.tree_util.tree_map(np.asarray, tree),
                                                                   like=trainer.model).items()}

    with jax.enable_x64(True):
        jp64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        jloss64, jg64 = jrun(jp64, jnp.float64)
        tx = joptim.adam(1e-3)
        upd, _ = tx.update(jg64, tx.init(jp64), jp64)
        jnew64 = as_state(optax.apply_updates(jp64, upd))
        jg64 = as_state(jg64)
    b64 = copy.copy(batch)
    b64.inputs, b64.targets, b64.mask = batch.inputs.double(), batch.targets.double(), batch.mask.double()
    if model != "gat":
        b64.operator = batch.operator.double()
    loss64, _ = ttrain.train_step(model64, toptim.adam(model64.parameters(), 1e-3), b64)
    assert_close(loss64.numpy(), jloss64, FP64_RTOL, "fp64 loss")
    hold_grads({k: p.grad.numpy() for k, p in model64.named_parameters()}, jg64, FP64_RTOL, null, "fp64 gradient")
    for k, p in model64.named_parameters():
        assert_close(p.detach().numpy(), jnew64[k], FP64_RTOL, f"fp64 after Adam {k}")

    jloss, jg = jrun(to_jax(params), jnp.float32)
    jg = as_state(jg)
    loss, mad = trainer.update(batch)
    assert trainer.step == 1 and np.isfinite(float(mad))
    assert_close(loss.numpy(), jloss, STEP_RTOL, "fp32 loss")
    tg = {k: p.grad.numpy() for k, p in trainer.model.named_parameters()}
    tx = joptim.adam(1e-3)
    upd, _ = tx.update(to_jax(tg), tx.init(to_jax(state)), to_jax(state))
    new = optax.apply_updates(to_jax(state), upd)
    top = max(float(np.linalg.norm(g)) for g in jg64.values())
    for k, p in trainer.model.named_parameters():
        g, ref = tg[k], jg64[k]
        assert np.isfinite(g).all(), f"{k}: not finite"
        if k in null:
            assert np.linalg.norm(g) <= NULL_FP32 * top, f"fp32 null grad {k}: {np.linalg.norm(g):.3e}"
        else:
            assert (g != 0).any(), f"{k}: no gradient"
            bound = FP32_RATIO * _fro(jg[k], ref) + 1e-6
            assert _fro(g, ref) <= bound, f"fp32 grad {k}: {_fro(g, ref):.3e} from fp64 > {bound:.3e}"
        err = float(np.abs(p.detach().numpy() - np.asarray(new[k])).max())
        assert err <= ADAM_ATOL, f"{k}: after one Adam update max|err|={err:.3e}"

@pytest.mark.parametrize("name", ["gat", "id"])
def test_zoo_bf16_matches_flax(name):
    """GatDeepModel-3 and IdDeepModel-3 at ``dtype=bf16`` against the JAX
    package's, on an RCM-ordered 150-vertex blob in ELL (GAT's attends in
    fp32 on the bf16 features, its scores in fp32): the output within
    BF16_OUT_RTOL and the step unit by unit (``hold_bf16_model``)."""
    L, mask, rng = bf16_mesh(N=256)
    jop, top = operators(L, 256, "ell", 2)
    x = (rng.normal(size=(2, 256, 3)) * mask).astype(np.float32)
    tgt = np.random.default_rng(4).normal(size=(2, 256, 3)).astype(np.float32)
    tm, tt = torch.from_numpy(mask), torch.from_numpy(tgt)
    worst = hold_bf16_model(f"{name} bf16", JMODELS[name](3, 3, 3, dtype=BF16),
                            TMODELS[name](3, 3, 3, dtype=torch.bfloat16), (jop, jnp.asarray(mask), jnp.asarray(x)),
                            (top, tm, torch.from_numpy(x)), lambda o: tlosses.normal_cosine_loss(o, tm, tt), 17)
    assert worst["model_out"] > 0
