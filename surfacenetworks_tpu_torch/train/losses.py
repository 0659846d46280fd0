"""Losses and metrics (counterpart of ``surfacenetworks_tpu/train/losses.py``:
the normal-prediction loss and metric, the dcel family, the SDDMM
smoothness term, the FAUST metrics, the ARAP loss and the mesh-MNIST
classifier's and VAE's losses).

* ``normal_cosine_loss`` and ``mean_angle_deviation``: the normal trainer's
  masked ``1 - <n_hat, n>^2`` loss and its angle metric, which is computed
  without a graph (``arccos`` has an infinite derivative at 1).
* ``smooth_l1_sum``: the ARAP trainer's Huber sum per batch item.
* ``nll_loss`` and ``accuracy``: the mesh-MNIST classifier's NLL over
  log-softmax outputs and its share of correct argmaxes.
* ``log_normal_diag`` and ``vae_elbo_terms``: the VAE's diagonal-Gaussian
  log density and its two ELBO terms (masked reconstruction NLL, KLD).
* ``aggregate_G``: the ground-truth cost ``GA[:, liA[lB]] + GB[liB[lA], :]``.
* ``corr_feature_smoothness``: ``--smooth-reg``; cosine scores of
  neighbouring vertices' features through ``sparse.sddmm``, at the operator's
  pattern only.
* ``corr_delta_cross_entropy(_from_target)``: the argmin-target cross-entropy
  over full ``[N, M]`` logits.
* ``corr_smooth_l1`` and ``corr_softmin_cross_entropy``: the FAUST trainer's
  ``--loss sl1`` and ``cel`` over full logits against the padded cost.
* ``corr_dcel_streaming``: the same loss without the ``[N, M]`` logits; an
  autograd Function over 512-row tiles whose backward recomputes each tile's
  logits from the saved logsumexp.  The tile products are ``torch.matmul``,
  as the JAX package leaves them to XLA.  The backward's mirror of the
  ``-fb[target]`` term, a segment sum of ``fa`` by target
  (``jax.ops.segment_sum`` in the JAX package), is an ELL SpMM over the
  target's inverse (``target_inverse``), so it sums in a fixed order.
* ``streaming_corr_argmax``, ``corr_metrics_from_pred`` and
  ``corr_accuracy_metrics``: the FAUST accuracy metrics.

Inside a sharded context (``parallel_context``: a rank holds a slice of the
batch or of the vertex rows) each loss and metric returns this rank's
share: its own terms over the GLOBAL normaliser (the mask sum over every
sharded axis, or the global batch over the batch axis), so the global value
is the sum of the shares (``parallel_context.total``) and the gradients of
the shares, summed over the ranks, are the global loss's.  A term of pooled
outputs, which every rank of the vertex axis holds whole (the classifier's
NLL and accuracy, the VAE's KLD), enters as its ``replicated_share``.
``smooth_l1_sum`` takes the global batch size from its caller.

Under mixed precision the losses take their inputs at fp32 or wider
(``at_least_fp32`` at entry); the one exception is
``corr_feature_smoothness``, which runs its SDDMM on the bf16 features, as
the JAX package's does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from surfacenetworks_tpu_torch import parallel_context
from surfacenetworks_tpu_torch.nn.layers import at_least_fp32
from surfacenetworks_tpu_torch.sparse import kernels
from surfacenetworks_tpu_torch.sparse.ell import transpose_slot_map
from surfacenetworks_tpu_torch.sparse.ops import sddmm

BLOCK = 512  # rows per tile of the streaming head


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values [B,N]`` over the entries where ``mask [B,N,1]`` is 1."""
    m = mask[..., 0]
    return (values * m).sum() / parallel_context.total(m.sum()).clamp_min(1.0)


def _batch_mean(values: torch.Tensor) -> torch.Tensor:
    """Mean of ``values [B]`` over the global batch (this rank's share in a
    batch-sharded context)."""
    axis = parallel_context.batch_reduction_axis()
    if axis is None:
        return values.mean()
    n = parallel_context.total(torch.tensor(float(values.shape[0]), device=values.device), [axis])
    return values.sum() / n


def _unit(outputs: torch.Tensor) -> torch.Tensor:
    return outputs / torch.linalg.vector_norm(outputs, dim=-1, keepdim=True).clamp_min(1e-12)


def normal_cosine_loss(outputs: torch.Tensor, mask: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean over valid vertices of ``1 - <n_hat, n>^2``, ``n_hat`` the
    L2-normalised prediction (norm clamped at 1e-12)."""
    inner = (_unit(at_least_fp32(outputs)) * targets).sum(-1)
    return _masked_mean(1.0 - inner**2, mask)


def smooth_l1_sum(outputs: torch.Tensor, targets: torch.Tensor, batch_size: int) -> torch.Tensor:
    """The ARAP loss: the Huber sum with delta 1 (``0.5 d^2`` where ``|d| <
    1``, ``|d| - 0.5`` elsewhere) over every element, divided by the batch
    size."""
    return torch.nn.functional.smooth_l1_loss(at_least_fp32(outputs), targets, reduction="sum", beta=1.0) / batch_size


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of ``-log_probs[b, targets[b]]``."""
    return -parallel_context.replicated_share(
        _batch_mean(at_least_fp32(log_probs).gather(1, targets.long()[:, None])[:, 0]))


@torch.no_grad()
def accuracy(log_probs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Share of the batch whose argmax class is its target (fp32)."""
    return parallel_context.replicated_share(_batch_mean((torch.argmax(log_probs, dim=1) == targets.long()).float()))


def log_normal_diag(z: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """Elementwise diagonal-Gaussian log density of ``z``."""
    return -0.5 * (math.log(2 * math.pi) + logvar + (z - mu) ** 2 / torch.exp(logvar))


def vae_elbo_terms(recon_mu, recon_logvar, mask, x, z, mu, logvar) -> tuple[torch.Tensor, torch.Tensor]:
    """(BCE, KLD) of the VAE: BCE the reconstruction's diagonal-Gaussian NLL
    over the valid vertices (``mask [B, N, 1]``), summed per sample and
    averaged over the batch; KLD ``log q(z) - log p(z)`` against a standard
    normal, summed over the latent and averaged over the batch."""
    b = x.shape[0]
    recon_mu, recon_logvar, z, mu, logvar = map(at_least_fp32, (recon_mu, recon_logvar, z, mu, logvar))
    mk = mask.expand(*mask.shape[:-1], x.shape[-1]).reshape(b, -1)
    rec = log_normal_diag(x.reshape(b, -1), recon_mu.reshape(b, -1), recon_logvar.reshape(b, -1))
    bce = -_batch_mean((rec * mk).sum(dim=1))
    zero = torch.zeros_like(z)
    kld = parallel_context.replicated_share(
        _batch_mean((log_normal_diag(z, mu, logvar) - log_normal_diag(z, zero, zero)).sum(dim=1)))
    return bce, kld


@torch.no_grad()
def mean_angle_deviation(outputs: torch.Tensor, mask: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean over valid vertices of ``arccos |<n_hat, n>|`` (radians)."""
    inner = (_unit(at_least_fp32(outputs)) * targets).sum(-1).abs().clamp(0.0, 1.0)
    return _masked_mean(torch.arccos(inner), mask)


def aggregate_G(GA, lA, liA, GB, lB, liB):
    """Ground-truth correspondence cost ``GA[:, liA[lB]] + GB[liB[lA], :]``
    (per sample)."""
    return GA[:, liA[lB]] + GB[liB[lA], :]


def corr_feature_smoothness(op, f: torch.Tensor) -> torch.Tensor:
    """``-sum_{(i,j) in pattern(op), i != j} |w_ij| cos(f_i, f_j) / sum |w|``.

    ``op`` is the batched ELL operator whose values (cotan weights) are the
    edge weights; padding slots have value 0 and drop out, and the diagonal
    self-entries are excluded (their cosine is the constant 1).  ``f
    [B, N, C]``, in its own dtype: bf16 features give bf16 scores, which the
    fp32 weights promote."""
    fn = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True).clamp_min(1e-9)
    scores = sddmm(op, fn, fn)  # [B, N, K] at the pattern slots
    cols = op.fwd.cols
    rows = torch.arange(cols.shape[-2], device=cols.device)[:, None]
    w = op.fwd.vals.abs() * (cols != rows)
    return -(w * scores).sum() / (w.sum() + 1e-9)


def corr_delta_cross_entropy_from_target(outputs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """dcel from a precomputed argmin target (constant per shape pair)."""
    logp = torch.log_softmax(outputs, dim=-1)
    return -logp.gather(-1, target[..., None].long()).mean()


def corr_delta_cross_entropy(outputs: torch.Tensor, GAB: torch.Tensor) -> torch.Tensor:
    """Argmin-target cross-entropy, the reference's default 'dcel'."""
    return corr_delta_cross_entropy_from_target(outputs, torch.argmin(GAB, dim=-1))


def corr_smooth_l1(outputs: torch.Tensor, GAB: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 between the logits and the aggregated geodesic cost: the
    element mean, divided by ``outputs.shape[0]`` (the rows of the 2-D
    logits, as the JAX package divides; padded columns cost 1e9)."""
    d = (at_least_fp32(outputs) - GAB).abs()
    per = torch.where(d < 1.0, 0.5 * d**2, d - 0.5)
    return per.mean() / outputs.shape[0]


def corr_softmin_cross_entropy(outputs: torch.Tensor, GAB: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the logits against ``softmin(GAB)`` over each row,
    summed; rows past A's vertices (cost 0 on B's columns) get a uniform
    target over them and enter the sum, as in the JAX package."""
    G = torch.softmax(-GAB, dim=1)
    logp = torch.log_softmax(at_least_fp32(outputs), dim=-1)
    return -(G * logp).sum()


def _stream_lse(fa, fb, target, block):
    """Per-row logsumexp and target logit of ``fa @ fb.T``, one
    ``[block, M]`` tile at a time."""
    lse, tlogit = [], []
    for i0 in range(0, fa.shape[0], block):
        logits = fa[i0 : i0 + block] @ fb.T
        lse.append(torch.logsumexp(logits, dim=-1))
        tlogit.append(logits.gather(1, target[i0 : i0 + block, None].long())[:, 0])
    return torch.cat(lse), torch.cat(tlogit)


def target_inverse(target: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The inverse of a row -> column map ``target [N]`` (values in
    ``[0, m)``) as an ELL matrix on ``target``'s device: row ``j`` lists the
    rows ``r`` with ``target[r] == j`` in ascending order, with value 1,
    padded (column 0, value 0) to the largest multiplicity.  Then
    ``ell_matmul(cols, vals, fa)`` is ``segment_sum(fa, target, m)`` summed
    in that fixed order.  Built on the host, once per target."""
    t = target.detach().cpu().numpy().astype(np.int32)[:, None]
    slots, cols = transpose_slot_map(t, np.ones(t.shape, np.float32), m)
    vals = (slots != t.shape[0]).astype(np.float32)
    return torch.from_numpy(cols).to(target.device), torch.from_numpy(vals).to(target.device)


class _StreamingDcel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fa, fb, target, block, target_inv):
        lse, tlogit = _stream_lse(fa, fb, target, block)
        ctx.save_for_backward(fa, fb, target, lse)
        ctx.block, ctx.target_inv = block, target_inv
        return -(tlogit - lse).mean()

    @staticmethod
    def backward(ctx, g):
        fa, fb, target, lse = ctx.saved_tensors
        block = ctx.block
        scale = g / fa.shape[0]  # d(-mean)/d(row)
        tgt = target.long()
        dfa = torch.empty_like(fa)
        dfb = torch.zeros_like(fb)
        for i0 in range(0, fa.shape[0], block):
            fa_b = fa[i0 : i0 + block]
            p = torch.exp(fa_b @ fb.T - lse[i0 : i0 + block, None])  # softmax rows
            dfa[i0 : i0 + block] = scale * (p @ fb - fb[tgt[i0 : i0 + block]])
            dfb += scale * (p.T @ fa_b)
        # the -fb[target] term of dfa has its mirror in dfb
        inv_cols, inv_vals = ctx.target_inv or target_inverse(target, fb.shape[0])
        dfb -= scale * kernels.ell_matmul(inv_cols, inv_vals, fa.contiguous())
        return dfa, dfb, None, None, None


def streaming_corr_delta_cross_entropy(fa, fb, target, block: int = BLOCK, target_inv=None) -> torch.Tensor:
    """dcel of ``fa @ fb.T`` against ``target`` without the ``[N, M]``
    logits (``fa [N, C]``, ``fb [M, C]``, ``target [N]``): equal to
    ``corr_delta_cross_entropy_from_target(fa @ fb.T, target)``.
    ``target_inv`` is ``target_inverse(target, M)`` where the caller caches
    it; without it the backward builds it (a copy to the host)."""
    return _StreamingDcel.apply(fa, fb, target, block, target_inv)


def corr_dcel_streaming(fa, fb, target, block: int = BLOCK, target_inv=None) -> torch.Tensor:
    """Batched front end: ``[B, N, C]`` features and ``[B, N]`` targets (and
    a list of per-sample ``target_inv`` maps) give the mean of the
    per-sample losses; the 2-D form passes through."""
    if fa.dim() == 3:
        target_inv = target_inv or [None] * fa.shape[0]
        return torch.stack(
            [streaming_corr_delta_cross_entropy(a, b, t, block, i) for a, b, t, i in zip(fa, fb, target, target_inv)]
        ).mean()
    return streaming_corr_delta_cross_entropy(fa, fb, target, block, target_inv)


def streaming_corr_argmax(fa, fb, mask_b, block: int = BLOCK) -> torch.Tensor:
    """``argmax_j <fa_i, fb_j>`` over valid columns, tile by tile:
    ``fa [N, C]``, ``fb [M, C]``, ``mask_b [M]`` -> int32 ``[N]``."""
    col_ok = mask_b > 0
    preds = []
    for i0 in range(0, fa.shape[0], block):
        logits = fa[i0 : i0 + block] @ fb.T
        logits = torch.where(col_ok[None, :], logits, torch.full_like(logits, -torch.inf))
        preds.append(torch.argmax(logits, dim=-1).to(torch.int32))
    return torch.cat(preds)


def corr_metrics_from_pred(pred, lA, lB, liB, GB, mask_a) -> dict:
    """FAUST accuracy of predictions ``pred [N]`` (vertices of B): the share
    of valid A vertices whose prediction carries A's label (``exact``), and
    the mean and quartiles of the distance on B between the prediction and
    the true correspondent ``liB[lA]``.  Inputs padded to the bucket."""
    pred = pred.long()
    gt = liB[lA]
    valid = mask_a > 0
    nvalid = valid.sum().clamp_min(1)
    exact = (valid & (lB[pred] == lA)).sum() / nvalid
    geo = GB[gt, pred]
    geo_mean = torch.where(valid, geo, torch.zeros_like(geo)).sum() / nvalid
    geo_sorted = torch.sort(torch.where(valid, geo, torch.full_like(geo, torch.inf))).values

    def q(p):
        idx = torch.floor(p * (nvalid - 1).to(torch.float32)).long().clamp(0, geo.shape[0] - 1)
        return geo_sorted[idx]

    return {"exact": exact, "geo_mean": geo_mean, "geo_q25": q(0.25), "geo_q50": q(0.5), "geo_q75": q(0.75)}


def corr_accuracy_metrics(logits, lA, lB, liB, GB, mask_a, mask_b) -> dict:
    """``corr_metrics_from_pred`` of the argmax of full ``[N, M]`` logits
    over the valid columns."""
    logits = torch.where(mask_b[None, :] > 0, logits, torch.full_like(logits, -torch.inf))
    return corr_metrics_from_pred(torch.argmax(logits, dim=-1), lA, lB, liB, GB, mask_a)
