"""The BSR operator's live-chunk mask (``sparse/bsr.py::live_chunks``), with
which the bf16 ``bsr_matmul`` kernel skips the 64-row x 32-deep chunks of
its stored 128x128 blocks that hold only zeros.

The JAX package has no such mask, so it is held against a recount of the
chunks in numpy (fp32 and bf16 blocks, forward and stored transpose,
batched, with padding slots), followed through stacking, ``.to`` and the
device store, and a walk over the live chunks alone is held against
``bsr_matmul_plain`` bit for bit.  The walk uses small integer values, where
every product and sum is exact in fp32, so no order of summation can hide a
chunk the mask dropped; one cleared bit must change the result.  On the
CPU the wrapper ignores the mask (the plain version reads every chunk), so
what the mask does to the kernel's results is checked on the card, by
``chip_smoke.py``.  ``bsr_bf16_sweep.py``'s count of each CTA's chunks is
held against the recount, and the sweep must refuse to run without a
card."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from surfacenetworks_tpu_torch.data import Buckets, fit_bsr_k, laplacian_batch, rcm_reorder_sample
from surfacenetworks_tpu_torch.data.pipeline import DeviceDataset, PackedSamples
from surfacenetworks_tpu_torch.sparse import bsr as tbsr
from surfacenetworks_tpu_torch.sparse import kernels, ops

from torch_parity import blob_laplacian, rcm

N = 384  # three block-rows
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def _laplacian(seed: int):
    return rcm(blob_laplacian(seed, 300)[2])


def _operators(dtype: torch.dtype) -> tuple[tbsr.BsrOperator, list]:
    """Two meshes' operators stacked, each block-row with two padding slots
    past the larger fitted count; and the scipy operators."""
    Ls = [_laplacian(seed) for seed in (5, 6)]
    k = 2 + max(max(tbsr.bsr_from_scipy(M, n_rows=N, n_cols=N).block_cols.shape[-1] for M in (L, L.T)) for L in Ls)
    ops_ = [tbsr.bsr_operator_from_scipy(L, k=k, k_bwd=k, n_rows=N, n_cols=N, dtype=dtype) for L in Ls]
    return tbsr.stack_bsr_operators(ops_), Ls


def _recount(m: tbsr.BsrMatrix) -> np.ndarray:
    """Bit 4 h + d of each slot: rows 64 h.., columns 32 d.. of its block
    hold a nonzero and its block-column is in range."""
    vals, cols = m.block_vals.float().numpy(), m.block_cols.numpy()
    out = np.zeros(cols.shape, np.uint8)
    for idx in np.ndindex(*cols.shape):
        if not 0 <= cols[idx] < m.n_cols // 128:
            continue
        for h in range(2):
            for d in range(4):
                if np.any(vals[idx][64 * h:64 * h + 64, 32 * d:32 * d + 32] != 0):
                    out[idx] |= 1 << (4 * h + d)
    return out


@pytest.mark.parametrize("side", ["fwd", "bwd"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_live_mask_matches_a_recount(dtype, side):
    op, _ = _operators(DTYPES[dtype])
    m, live = getattr(op, side), getattr(op, f"{side}_live")
    assert live.dtype == torch.uint8 and live.shape == m.block_cols.shape == (2, 3, live.shape[-1])
    want = _recount(m)
    np.testing.assert_array_equal(live.numpy(), want)
    # the case is not trivial: padding slots have no bit, and live slots have dead chunks
    padding = ~m.block_vals.flatten(-2).ne(0).any(-1).numpy()
    assert padding.any() and (want[padding] == 0).all()
    assert ((want != 0) & (want != 255)).any()


def test_live_mask_clears_columns_out_of_range():
    op, _ = _operators(torch.float32)
    m = op.fwd
    cols = m.block_cols.clone()
    cols[0, 1, 0], cols[1, 2, 0] = -1, N // 128
    got = tbsr.live_chunks(tbsr.BsrMatrix(block_cols=cols, block_vals=m.block_vals, n_cols=m.n_cols))
    want = op.fwd_live.clone()
    want[0, 1, 0] = want[1, 2, 0] = 0
    assert op.fwd_live[0, 1, 0] != 0 and op.fwd_live[1, 2, 0] != 0
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _mesh_samples() -> list[dict]:
    out = []
    for seed in (5, 6):
        V, F, L = blob_laplacian(seed, 300)
        out.append(rcm_reorder_sample({"V": V, "F": F, "L": L, "input": V.astype(np.float32),
                                       "target": V.astype(np.float32)}))
    return out


@pytest.mark.parametrize("route", ["stack", "to", "device_store"])
def test_live_mask_travels_with_the_operator(route):
    if route == "stack":
        op, Ls = _operators(torch.bfloat16)
        assert op.fwd_live is not None and op.bwd_live is not None
        singles = [tbsr.bsr_operator_from_scipy(L, k=op.fwd.block_cols.shape[-1], k_bwd=op.bwd.block_cols.shape[-1],
                                                n_rows=N, n_cols=N, dtype=torch.bfloat16) for L in Ls]
        for side in ("fwd_live", "bwd_live"):
            torch.testing.assert_close(getattr(op, side), torch.stack([getattr(o, side) for o in singles]),
                                       rtol=0, atol=0)
        # an operator without a mask in the stack: the stack has none (every chunk is read)
        bare = tbsr.BsrOperator(fwd=singles[0].fwd, bwd=singles[0].bwd)
        assert tbsr.stack_bsr_operators([bare, singles[1]]).fwd_live is None
    elif route == "to":
        op, _ = _operators(torch.bfloat16)
        moved = op.to("cpu")
        for side in ("fwd_live", "bwd_live"):
            torch.testing.assert_close(getattr(moved, side), getattr(op, side), rtol=0, atol=0)
        assert tbsr.BsrOperator(fwd=op.fwd, bwd=op.bwd).to("cpu").fwd_live is None
    else:  # the trainers' device store: every sample stacked once, a batch gathered by rows
        samples = _mesh_samples()
        buckets = Buckets(n_vertices=N)
        fit_bsr_k(samples, buckets)
        packed = PackedSamples(lambda s: laplacian_batch([s], buckets, fmt="bsr", op_dtype=torch.bfloat16))
        store = DeviceDataset.build(samples, packed, "cpu")
        got = store.batch([samples[1], samples[0], samples[1]]).gather().operator
        for side in ("fwd", "bwd"):
            singles = [getattr(packed.one(s).operator, f"{side}_live")[0] for s in (samples[1], samples[0], samples[1])]
            torch.testing.assert_close(getattr(got, f"{side}_live"), torch.stack(singles), rtol=0, atol=0)
            np.testing.assert_array_equal(getattr(got, f"{side}_live").numpy(), _recount(getattr(got, side)))


def _walk_live(m: tbsr.BsrMatrix, live: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``m @ x`` from the live chunks alone, x rounded to the blocks' dtype
    as ``bsr_matmul_plain`` rounds it, summed in fp32."""
    vals = m.block_vals.float()
    xr = x.to(m.block_vals.dtype).float()
    B, nb, kb = m.block_cols.shape
    out = torch.zeros(B, nb * 128, x.shape[-1])
    for b, i, s in np.ndindex(B, nb, kb):
        col = int(m.block_cols[b, i, s])
        for h in range(2):
            for d in range(4):
                if int(live[b, i, s]) >> (4 * h + d) & 1:
                    rows = slice(i * 128 + 64 * h, i * 128 + 64 * h + 64)
                    out[b, rows] += vals[b, i, s, 64 * h:64 * h + 64, 32 * d:32 * d + 32] @ \
                        xr[b, col * 128 + 32 * d:col * 128 + 32 * d + 32]
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_walk_over_live_chunks_equals_plain(dtype):
    op, _ = _operators(DTYPES[dtype])
    rng = np.random.default_rng(11)
    m = op.fwd
    pattern = m.block_vals.float().numpy() != 0
    ints = rng.integers(1, 4, size=pattern.shape) * rng.choice([-1, 1], size=pattern.shape)
    m = tbsr.BsrMatrix(block_cols=m.block_cols, block_vals=torch.from_numpy(np.where(pattern, ints, 0).astype(np.float32))
                       .to(DTYPES[dtype]), n_cols=m.n_cols)
    live = tbsr.live_chunks(m)
    torch.testing.assert_close(live, op.fwd_live, rtol=0, atol=0)  # the same pattern, the same mask
    x = torch.from_numpy(rng.integers(-4, 5, size=(2, N, 24)).astype(np.float32))
    want = kernels.bsr_matmul_plain(m.block_cols, m.block_vals, x)
    assert torch.equal(_walk_live(m, live, x), want)
    # one live chunk's bit cleared: its terms are gone
    b, i, s = (int(v) for v in torch.nonzero(live)[len(torch.nonzero(live)) // 2])
    mutant = live.clone()
    mutant[b, i, s] = int(live[b, i, s]) & (int(live[b, i, s]) - 1)
    assert not torch.equal(_walk_live(m, mutant, x), want)


def test_live_argument_on_cpu_is_the_plain_version():
    """On CPU tensors the wrapper takes the plain version, which reads every
    chunk, and counts no launch."""
    op, _ = _operators(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(13).normal(size=(2, N, 8)).astype(np.float32))
    before = dict(kernels.launches)
    got = kernels.bsr_matmul(op.fwd.block_cols, op.fwd.block_vals, x, op.fwd_live)
    assert torch.equal(got, kernels.bsr_matmul_plain(op.fwd.block_cols, op.fwd.block_vals, x))
    assert kernels.launches == before


def test_other_block_sizes_carry_no_mask():
    """Only the kernels' 128x128 blocks get a mask; an operator of other
    blocks is still built (as the JAX package builds it) and applies
    through the plain version."""
    L = _laplacian(5)
    op = tbsr.bsr_operator_from_scipy(L, block_size=64, n_rows=N, n_cols=N)
    assert op.fwd_live is None and op.bwd_live is None
    with pytest.raises(ValueError, match="128x128"):
        tbsr.live_chunks(op.fwd)
    x = torch.from_numpy(np.random.default_rng(14).normal(size=(N, 4)).astype(np.float32))
    n = L.shape[0]
    torch.testing.assert_close(ops.bsr_spmm(op, x)[:n], torch.from_numpy(L.toarray().astype(np.float32)) @ x[:n],
                               rtol=1e-5, atol=1e-3)


REPO = Path(__file__).resolve().parents[1]


def test_sweep_counts_each_ctas_chunks(monkeypatch):
    """``bsr_bf16_sweep.py`` counts the depth chunks each CTA of the bf16
    kernel (a block-row's 64-row half) multiplies: with the mask its live
    ones, held against the recount; without it four per in-range slot."""
    monkeypatch.syspath_prepend(str(REPO))
    import bsr_bf16_sweep

    op, _ = _operators(torch.bfloat16)
    m, live = op.fwd, op.fwd_live
    bits = _recount(m)[0]
    want = np.array([[bin(int(b) >> (4 * h) & 15).count("1") for b in row] for h in range(2) for row in bits]).sum(1)
    got = bsr_bf16_sweep.per_cta_chunks(m.block_cols[0], live[0], N // 128)
    assert got["live"]["sum"] == want.sum() and got["live"]["max"] == want.max() and got["live"]["min"] == want.min()
    assert got["live"]["histogram"] == {int(k): int(n) for k, n in zip(*np.unique(want, return_counts=True))}
    assert got["every"]["sum"] == 2 * 4 * m.block_cols[0].numel()  # every slot's column is in range here
    assert 0 < got["live"]["sum"] < got["every"]["sum"]


def test_sweep_needs_a_card():
    """Without a CUDA card the sweep exits non-zero and prints no result."""
    res = subprocess.run([sys.executable, "bsr_bf16_sweep.py"], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""}, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
    assert "needs a CUDA card" in res.stderr
