"""Model zoo (counterpart of ``surfacenetworks_tpu/models``)."""

from surfacenetworks_tpu_torch.models.normal_models import LapDeepModel, init_weights

__all__ = ["LapDeepModel", "init_weights"]
