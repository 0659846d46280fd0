"""Model zoo (counterpart of ``surfacenetworks_tpu/models``)."""

from surfacenetworks_tpu_torch.models import mnist_models, vae
from surfacenetworks_tpu_torch.models.correspondence import SiameseModel
from surfacenetworks_tpu_torch.models.normal_models import DirDeepModel, DirModelToFace, LapDeepModel, init_weights
from surfacenetworks_tpu_torch.models.vae import DirVAE, LapVAE

__all__ = ["DirDeepModel", "DirModelToFace", "DirVAE", "LapDeepModel", "LapVAE", "SiameseModel", "init_weights",
           "mnist_models", "vae"]
