"""Model zoo (counterpart of ``surfacenetworks_tpu/models``)."""

from surfacenetworks_tpu_torch.models.correspondence import SiameseModel
from surfacenetworks_tpu_torch.models.normal_models import DirDeepModel, DirModelToFace, LapDeepModel, init_weights

__all__ = ["DirDeepModel", "DirModelToFace", "LapDeepModel", "SiameseModel", "init_weights"]
