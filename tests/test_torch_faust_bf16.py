"""Each new FAUST trunk's ``--bf16`` step held unit by unit against flax
(``torch_parity.hold_bf16_units``).  Moved from
``tests/test_torch_faust_modes.py``, whose module docstring states the
method and whose helpers these tests share, so the suite's files balance
across workers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from surfacenetworks_tpu.models import SiameseModel as JSiameseModel
from surfacenetworks_tpu.train import losses as jlosses
from surfacenetworks_tpu.train import optim as joptim
from surfacenetworks_tpu_torch.cli import train_correspondence as ttrain
from surfacenetworks_tpu_torch.convert import params_from_flax

from test_torch_bf16_train import _hold_step, _jax_loss
from test_torch_faust_modes import BF16_CASES, FAUST, _trainer
from test_torch_faust_trunks import jax_pair, jops
from torch_parity import BF16, perturbed_params, unit_calls


@pytest.mark.parametrize("case", list(BF16_CASES))
def test_trunk_bf16_step_matches_jax(case, tmp_path):
    """The trainer's ``--bf16`` update (ELL, the full-logits dcel head, 0.1
    x smoothness on the bf16 features) against the JAX trainer's objective
    at ``dtype=bf16``: the loss within 8U (U = 2^-8) of JAX's, every layer
    and block held unit by unit, the parameters after the update optax's
    (``test_torch_bf16_train._hold_step``)."""
    flags, layers = BF16_CASES[case]
    trainer = _trainer(["--datapath", str(FAUST), "--device", "cpu", "--layer", str(layers), "--operator-format",
                        "ell", "--smooth-reg", "0.1", "--num-updates", "1", "--num-epoch", "1", "--bf16",
                        "--result-dir", str(tmp_path), *flags])
    batches, regs, target = jax_pair(trainer.model_key)
    regs = [jax.tree_util.tree_map(jnp.asarray, r) for r in regs]
    tgt = jnp.asarray(target)
    rots = (0.7, 0.0, 2.3, 0.0)
    xs = [jnp.asarray(np.asarray(b.inputs) @ ttrain.rot_matrix(rots[2 * i], rots[2 * i + 1], "cpu").numpy())
          for i, b in enumerate(batches)]
    ops = [jops(b) for b in batches]
    j16 = JSiameseModel(model=trainer.args.model, layers=layers, dtype=BF16)

    def obj(p):
        fa, fb = j16.apply({"params": p}, ops[0], ops[1], *xs, method=JSiameseModel.features)
        loss = jlosses.corr_delta_cross_entropy_from_target(
            jnp.einsum("bnc,bmc->bnm", fa, fb, preferred_element_type=jnp.float32)[0], tgt)
        return loss + 0.1 * (jlosses.corr_feature_smoothness(regs[0], fa) + jlosses.corr_feature_smoothness(regs[1], fb))

    params = perturbed_params(j16.init(jax.random.key(0), ops[0], ops[0], xs[0], xs[0])["params"], 15)
    state = params_from_flax(params, like=trainer.model)
    trainer.model.load_state_dict(state, strict=True)
    jloss, _ = _jax_loss(obj, params)
    with unit_calls(trainer.model) as recorded:
        loss = trainer.update(0, 1, rots)
    assert trainer.step == 1
    _hold_step(f"FAUST {case} bf16", trainer.model, state, loss, jloss, recorded, obj, params,
               joptim.adam(1e-3, weight_decay=1e-5))
