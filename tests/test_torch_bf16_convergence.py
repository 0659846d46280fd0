"""The decisive mixed-precision check of ``tests/test_bf16.py`` in the port
(moved here from ``tests/test_torch_bf16_models.py``, whose helpers and
fixture it shares, so the suite's files balance across workers): from the
same init and data, 40 Adam steps of LapDeepModel-3 in fp32 and in bf16."""

from surfacenetworks_tpu_torch.models import normal_models as tnormal
from surfacenetworks_tpu_torch.train import losses as tlosses
from surfacenetworks_tpu_torch.train import optim as toptim

from test_torch_bf16_models import BFT, _seeded, lap_batch  # noqa: F401  (lap_batch: the shared fixture)


def test_bf16_training_converges(lap_batch):
    """The decisive mixed-precision check of ``tests/test_bf16.py``: from
    the same init and data, 40 Adam steps each; both losses fall below half
    their first, and the bf16 loss ends below 3x the fp32 loss + 1e-3."""
    b = lap_batch
    m32 = _seeded(tnormal.LapDeepModel(3, 3, layers=3))
    m16 = tnormal.LapDeepModel(3, 3, layers=3, dtype=BFT)
    m16.load_state_dict(m32.state_dict())
    finals = {}
    for name, model in (("fp32", m32), ("bf16", m16)):
        opt = toptim.adam(model.parameters(), 1e-3)
        first = None
        for _ in range(40):
            opt.zero_grad(set_to_none=True)
            loss = tlosses.normal_cosine_loss(model(b.operator, b.mask, b.inputs), b.mask, b.targets)
            loss.backward()
            opt.step()
            first = float(loss) if first is None else first
        finals[name] = float(loss)
        assert finals[name] < 0.5 * first, (name, first, finals[name])
    assert finals["bf16"] < 3.0 * finals["fp32"] + 1e-3, finals
