"""Surface-Networks VAE for mesh-MNIST generation, Lap and Dirac variants
(counterpart of ``surfacenetworks_tpu/models/vae.py``).

The encoder reads the lifted mesh through its operator: conv1 -> blocks ->
ELU -> 'pre' conv ``bn_conv2`` -> ELU -> masked global average -> the
latent heads ``fc_mu`` and ``fc_logvar`` (at least fp32).  The decoder
reads the flat (z = 0) mesh through the flat operator, with the latent
repeated over the vertices: ``conv_inputs(flat x) + conv_noise(latent)`` ->
blocks -> ELU -> ``bn_conv2`` -> ELU -> ``fc_mu``; its mean is that output
plus the flat inputs (at least fp32), its log-variance one learned scalar
``fc_logvar [1, 1, 1]`` broadcast to the output.

The reparametrisation noise ``eps`` comes from the caller (so a test can
hand in the JAX package's) or is drawn from ``generator`` on the model's
device.  Module names follow the JAX package's flax names (``encoder``,
``decoder``, ``conv1``, ``conv_inputs``, ``conv_noise``, ``rn{i}``,
``bn_conv2``, ``fc_mu``, ``fc_logvar``), so ``convert.params_from_flax``
maps a flax tree onto ``state_dict``; the decoder's ``fc_logvar`` is a bare
parameter, the encoder's a Linear.  ``dtype`` is the computation dtype of
every ``GraphConv1x1`` and block (bf16: mixed precision); the latent heads,
the noise and the reconstruction mean are fp32 whatever it is, as in the
JAX models.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from surfacenetworks_tpu_torch.nn.blocks import DirResNet2, LapResNet2, dirac_num_faces
from surfacenetworks_tpu_torch.nn.layers import GraphConv1x1, at_least_fp32, global_average

WIDTH = 128
LATENT = 100


class _Blocks(nn.Module):
    """``num_layers`` residual blocks ``rn{i}`` over the vertex stream:
    Laplacian blocks, or with ``dirac`` Dirac blocks whose face stream
    starts at zero."""

    def __init__(self, num_layers: int, dirac: bool, dtype: torch.dtype | None = None):
        super().__init__()
        self.num_layers, self.dirac = num_layers, dirac
        for i in range(num_layers):
            self.add_module(f"rn{i}", DirResNet2(WIDTH, dtype=dtype) if dirac else LapResNet2(WIDTH, dtype=dtype))

    def blocks(self, op, mask, x: torch.Tensor) -> torch.Tensor:
        f = x.new_zeros(x.shape[0], dirac_num_faces(op), WIDTH) if self.dirac else None
        for i in range(self.num_layers):
            block = getattr(self, f"rn{i}")
            if self.dirac:
                x, f = block(op, x, f)
            else:
                x = block(op, mask, x)
        return x


class _Encoder(_Blocks):
    DIRAC = False

    def __init__(self, num_layers: int = 5, dtype: torch.dtype | None = None):
        super().__init__(num_layers, self.DIRAC, dtype)
        self.conv1 = GraphConv1x1(3, WIDTH, None, dtype=dtype)
        self.bn_conv2 = GraphConv1x1(WIDTH, WIDTH, "pre", dtype=dtype)
        self.fc_mu = nn.Linear(WIDTH, LATENT)
        self.fc_logvar = nn.Linear(WIDTH, LATENT)

    def forward(self, inputs, op, mask) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.blocks(op, mask, self.conv1(inputs))
        x = F.elu(self.bn_conv2(F.elu(x)))
        x = at_least_fp32(global_average(x, mask).squeeze(-2))
        return self.fc_mu(x), self.fc_logvar(x)


class _Decoder(_Blocks):
    DIRAC = False

    def __init__(self, num_layers: int = 5, dtype: torch.dtype | None = None):
        super().__init__(num_layers, self.DIRAC, dtype)
        self.conv_inputs = GraphConv1x1(3, WIDTH, None, dtype=dtype)
        self.conv_noise = GraphConv1x1(LATENT, WIDTH, None, dtype=dtype)
        self.bn_conv2 = GraphConv1x1(WIDTH, WIDTH, "pre", dtype=dtype)
        self.fc_mu = GraphConv1x1(WIDTH, 3, None, dtype=dtype)
        self.fc_logvar = nn.Parameter(torch.zeros(1, 1, 1))

    def forward(self, inputs, noise, op, mask) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.blocks(op, mask, self.conv_inputs(inputs) + self.conv_noise(noise))
        x = F.elu(self.bn_conv2(F.elu(x)))
        mu = at_least_fp32(self.fc_mu(x)) + inputs
        return mu, self.fc_logvar.expand_as(mu)


class LapEncoder(_Encoder):
    pass


class DirEncoder(_Encoder):
    DIRAC = True


class LapDecoder(_Decoder):
    pass


class DirDecoder(_Decoder):
    DIRAC = True


class _VAE(nn.Module):
    ENCODER, DECODER = LapEncoder, LapDecoder

    def __init__(self, num_layers: int = 5, dtype: torch.dtype | None = None):
        super().__init__()
        self.encoder = self.ENCODER(num_layers, dtype)
        self.decoder = self.DECODER(num_layers, dtype)

    def forward(self, x, flat_x, op, flat_op, mask, eps=None, generator=None):
        """(recon_mu, recon_logvar, z, mu, logvar); ``z = eps * exp(logvar
        / 2) + mu`` with ``eps`` given or drawn from ``generator``."""
        mu, logvar = self.encoder(x, op, mask)
        std = torch.exp(0.5 * logvar)
        if eps is None:
            eps = torch.randn(std.shape, generator=generator, device=std.device, dtype=std.dtype)
        z = eps * std + mu
        z_tiled = z[:, None, :].expand(-1, flat_x.shape[1], -1)
        recon_mu, recon_logvar = self.decoder(flat_x, z_tiled, flat_op, mask)
        return recon_mu, recon_logvar, z, mu, logvar

    def decode(self, flat_x, noise, flat_op, mask) -> tuple[torch.Tensor, torch.Tensor]:
        """The generative path: the decoder on ``noise [B, N, LATENT]``."""
        return self.decoder(flat_x, noise, flat_op, mask)


class LapVAE(_VAE):
    """Laplacian blocks; ``op`` and ``flat_op`` are Laplacian operators."""


class DirVAE(_VAE):
    """Dirac blocks; ``op`` and ``flat_op`` are ``DiracOperator``s or dense
    (Di, DiA) pairs."""

    ENCODER, DECODER = DirEncoder, DirDecoder


MODELS = {"lap": LapVAE, "dirac": DirVAE}
