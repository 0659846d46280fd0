"""Model zoo (counterpart of ``surfacenetworks_tpu/models``)."""

from surfacenetworks_tpu_torch.models import arap_models, correspondence, mnist_models, vae
from surfacenetworks_tpu_torch.models.cascade import EfficientCascade, GlobalLocalModel, LapMATModel
from surfacenetworks_tpu_torch.models.correspondence import SiameseModel
from surfacenetworks_tpu_torch.models.normal_models import (
    AvgModel,
    DirDeepModel,
    DirModelToFace,
    GatDeepModel,
    IdDeepModel,
    LapDeepModel,
    MlpModel,
    init_weights,
)
from surfacenetworks_tpu_torch.models.vae import DirVAE, LapVAE

__all__ = ["AvgModel", "DirDeepModel", "DirModelToFace", "DirVAE", "EfficientCascade", "GatDeepModel",
           "GlobalLocalModel", "IdDeepModel", "LapDeepModel", "LapMATModel", "LapVAE", "MlpModel", "SiameseModel",
           "arap_models", "correspondence", "init_weights", "mnist_models", "vae"]
