"""Dense-correspondence losses and metrics (counterpart of
``surfacenetworks_tpu/train/losses.py``, the dcel family, the SDDMM
smoothness term and the FAUST metrics).

* ``aggregate_G``: the ground-truth cost ``GA[:, liA[lB]] + GB[liB[lA], :]``.
* ``corr_feature_smoothness``: ``--smooth-reg``; cosine scores of
  neighbouring vertices' features through ``sparse.sddmm``, at the operator's
  pattern only.
* ``corr_delta_cross_entropy(_from_target)``: the argmin-target cross-entropy
  over full ``[N, M]`` logits.
* ``corr_dcel_streaming``: the same loss without the ``[N, M]`` logits; an
  autograd Function over 512-row tiles whose backward recomputes each tile's
  logits from the saved logsumexp.  The tile products are ``torch.matmul``,
  as the JAX package leaves them to XLA.
* ``streaming_corr_argmax``, ``corr_metrics_from_pred`` and
  ``corr_accuracy_metrics``: the FAUST accuracy metrics.
"""

from __future__ import annotations

import torch

from surfacenetworks_tpu_torch.sparse.ops import sddmm

BLOCK = 512  # rows per tile of the streaming head


def aggregate_G(GA, lA, liA, GB, lB, liB):
    """Ground-truth correspondence cost ``GA[:, liA[lB]] + GB[liB[lA], :]``
    (per sample)."""
    return GA[:, liA[lB]] + GB[liB[lA], :]


def corr_feature_smoothness(op, f: torch.Tensor) -> torch.Tensor:
    """``-sum_{(i,j) in pattern(op), i != j} |w_ij| cos(f_i, f_j) / sum |w|``.

    ``op`` is the batched ELL operator whose values (cotan weights) are the
    edge weights; padding slots have value 0 and drop out, and the diagonal
    self-entries are excluded (their cosine is the constant 1).  ``f
    [B, N, C]``."""
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


def _stream_lse(fa, fb, target, block):
    """Per-row logsumexp and target logit of ``fa @ fb.T``, one
    ``[block, M]`` tile at a time."""
    lse, tlogit = [], []
    for i0 in range(0, fa.shape[0], block):
        logits = fa[i0 : i0 + block] @ fb.T
        lse.append(torch.logsumexp(logits, dim=-1))
        tlogit.append(logits.gather(1, target[i0 : i0 + block, None].long())[:, 0])
    return torch.cat(lse), torch.cat(tlogit)


class _StreamingDcel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fa, fb, target, block):
        lse, tlogit = _stream_lse(fa, fb, target, block)
        ctx.save_for_backward(fa, fb, target, lse)
        ctx.block = block
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
        dfb -= scale * torch.zeros_like(fb).index_add_(0, tgt, fa)
        return dfa, dfb, None, None


def streaming_corr_delta_cross_entropy(fa, fb, target, block: int = BLOCK) -> torch.Tensor:
    """dcel of ``fa @ fb.T`` against ``target`` without the ``[N, M]``
    logits (``fa [N, C]``, ``fb [M, C]``, ``target [N]``): equal to
    ``corr_delta_cross_entropy_from_target(fa @ fb.T, target)``."""
    return _StreamingDcel.apply(fa, fb, target, block)


def corr_dcel_streaming(fa, fb, target, block: int = BLOCK) -> torch.Tensor:
    """Batched front end: ``[B, N, C]`` features and ``[B, N]`` targets give
    the mean of the per-sample losses; the 2-D form passes through."""
    if fa.dim() == 3:
        return torch.stack(
            [streaming_corr_delta_cross_entropy(a, b, t, block) for a, b, t in zip(fa, fb, target)]
        ).mean()
    return streaming_corr_delta_cross_entropy(fa, fb, target, block)


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
