// Hand-written Hopper (sm_90a) kernels for the port's sparse operator applies
// and the sampled dense-dense product (SDDMM).
//
// Built by sparse/_build.py with one plain nvcc call into a shared library
// with a C interface, loaded with ctypes (no PyTorch headers).  Every entry
// point launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// All tensors are contiguous; the wrappers in sparse/kernels.py check that.
//
// Each kernel has an fp32 variant and a bf16 variant (mixed-precision
// training, the trainers' --bf16).  The bf16 variants compute what the JAX
// package's XLA paths compute under bf16, which is what its trainers run:
// bf16 BSR blocks with x rounded to bf16 and an fp32 result
// (_bsr_matmul_xla), fp32 ELL values on bf16 x with an fp32 result
// (_ell_matmul_xla), and a bf16 SDDMM of bf16 features with fp32 sums
// (_sddmm_xla).  A bf16 value widens to fp32 exactly (its 16 bits become the
// high half of the fp32 word); every rounding to bf16 is to nearest even,
// as XLA's convert rounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// Scalar-ELL SpMM: out[b, r] = sum_k vals[b, r, k] * x[b, cols[b, r, k]]
//
// Replaces surfacenetworks_tpu/sparse/pallas_kernels.py::_ell_matmul_call.
// Bound: bytes (the slots, x and out once each).  But each row of x is
// gathered by every row that references it (about 7 of a Laplacian's), so
// the L2 cache serves several times x's bytes, and a row's gathers are round
// trips to it: that traffic and its latency hold the kernel back.  Design:
// one warp per output row, 16-byte lanes along the channel axis (one
// gathered row of 128 fp32 channels is one coalesced 512-byte read).  The
// warp takes the row's slots in chunks of kEllChunk: every lane reads the
// chunk's (col, val) pairs itself (16-byte broadcast loads where K and the
// pointers allow), issues all the chunk's gathers into registers, each
// predicated on a live slot (val != 0) and an in-range column rather than
// branched on, and only then does the FMAs.  A warp so has up to kEllChunk
// gathers in flight instead of one.  The FMAs run in slot order, one fixed
// order of summation, which the deterministic sums of the training backward
// (the SDDMM's db, the dcel head's mirror) rely on.  A column outside
// [0, n) adds nothing rather than being read out of bounds: a guard only,
// the operators' columns are range-checked on the host.
// ---------------------------------------------------------------------------
constexpr int kEllChunk = 8;  // slots whose gathers are in flight together

template <bool VEC4>
__device__ __forceinline__ float4 load4(const float* p, int j) {
  if (VEC4) return reinterpret_cast<const float4*>(p)[j];
  return make_float4(p[j], 0.f, 0.f, 0.f);
}

// At most 64 registers, so that 4 CTAs of 8 warps fit on an SM: on the H100
// the kernel is faster with more rows in flight than with more gathers per
// row (chunks of 16 slots at 108 registers, 2 CTAs per SM, measured slower).
template <bool VEC4>
__global__ void __launch_bounds__(256, 4)
ell_spmm_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                const float* __restrict__ x, float* __restrict__ out,
                int batch, int rows, int k, int n, int c, int pairs4) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(batch) * rows) return;  // whole warp leaves together
  const long long b = row / rows;
  const int* row_cols = cols + row * k;
  const float* row_vals = vals + row * k;
  const float* xb = x + b * n * static_cast<long long>(c);
  float* orow = out + row * c;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const int width = VEC4 ? c / 4 : c;  // channel axis in units of float4 or float
  for (int j0 = 0; j0 < width; j0 += 32) {
    const int j = j0 + lane;
    const bool live = j < width;
    float4 acc = zero;
    for (int s0 = 0; s0 < k; s0 += kEllChunk) {
      int col[kEllChunk];
      float val[kEllChunk];
      if (pairs4 && s0 + kEllChunk <= k) {
#pragma unroll
        for (int q = 0; q < kEllChunk / 4; ++q) {
          const int4 cq = __ldg(reinterpret_cast<const int4*>(row_cols + s0) + q);
          const float4 vq = __ldg(reinterpret_cast<const float4*>(row_vals + s0) + q);
          col[4 * q + 0] = cq.x; col[4 * q + 1] = cq.y; col[4 * q + 2] = cq.z; col[4 * q + 3] = cq.w;
          val[4 * q + 0] = vq.x; val[4 * q + 1] = vq.y; val[4 * q + 2] = vq.z; val[4 * q + 3] = vq.w;
        }
      } else {
#pragma unroll
        for (int s = 0; s < kEllChunk; ++s) {
          const bool in = s0 + s < k;
          col[s] = in ? __ldg(row_cols + s0 + s) : 0;
          val[s] = in ? __ldg(row_vals + s0 + s) : 0.f;
        }
      }
      // every gather of the chunk in flight before any FMA
      float4 xv[kEllChunk];
#pragma unroll
      for (int s = 0; s < kEllChunk; ++s) {
        const bool take = live && val[s] != 0.f && col[s] >= 0 && col[s] < n;
        val[s] = take ? val[s] : 0.f;
        xv[s] = take ? load4<VEC4>(xb + static_cast<long long>(col[s]) * c, j) : zero;
      }
#pragma unroll
      for (int s = 0; s < kEllChunk; ++s) {
        acc.x = fmaf(val[s], xv[s].x, acc.x);
        if (VEC4) {
          acc.y = fmaf(val[s], xv[s].y, acc.y);
          acc.z = fmaf(val[s], xv[s].z, acc.z);
          acc.w = fmaf(val[s], xv[s].w, acc.w);
        }
      }
    }
    if (live) {
      if (VEC4) {
        reinterpret_cast<float4*>(orow)[j] = acc;
      } else {
        orow[j] = acc.x;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Block-ELL SpMM over 128x128 blocks on the tensor cores, in 3xTF32:
//   out[b, i*128 + m, ch] = sum_s sum_j vals[b, i, s, m, j] * x[b, cols[b, i, s]*128 + j, ch]
//
// Replaces surfacenetworks_tpu/sparse/pallas_kernels.py::_bsr_matmul_call.
// Bound: bytes.  At NB=55, KB=5, C=128 the kernel reads 18 MB of stored
// blocks and 3.6 MB of x and writes 3.6 MB, about 0.0075 ms at 3.35 TB/s;
// its 1.15 GFLOP take three TF32 passes, 0.007 ms at 495 TFLOP/s.  fp32 FMA
// (67 TFLOP/s) would make it bound by operations at 0.017 ms.
//
// Accuracy: the port holds fp32, every element within 1e-5 of |A||x|.  One
// TF32 pass rounds each input to a 10-bit mantissa (about 5e-4 per
// product), so each operand is split in registers into a TF32 high part and
// a TF32 low part (hi = v rounded to nearest, lo = the rest rounded to
// nearest) and the three large cross products are summed in fp32 (A_lo x_hi
// + A_hi x_lo + A_hi x_hi, the small ones first): about 2^-21 relative per
// product.
//
// Design: one CTA of 4 warps per (64-channel tile, 64-row half of a
// block-row, batch item): 2 x 2 x 55 = 220 CTAs at C=128, several resident
// on each SM.  Each warp owns a 32 x 32 tile of the output in fp32
// registers and runs mma.sync m16n8k8 (row.col, tf32 in, f32 accumulate).
// The CTA walks its block-row's slots and each slot's depth in chunks of 32
// as one sequence; a 3-stage ring in shared memory holds each chunk of the
// block (64 x 32) and of x (32 x 64), filled by 16-byte cp.async.cg (4-byte
// cp.async.ca where x's rows are not 16-byte aligned), so the next two
// chunks, across slot boundaries, load while the current one multiplies.
// Row pitches of 36 and 72 floats make every fragment load free of bank
// conflicts.  wgmma, Hopper's route to the full tensor rate, takes TF32
// operands K-major only, which x (channels last) is not: it would need a
// transpose in shared memory.  The ragged channel edge and a block-column outside
// [0, n/128) are zero-filled on load (the source size of the copy is 0), so
// they add nothing; the channel edge is masked on store.
// ---------------------------------------------------------------------------
constexpr int kBs = 128;               // block size (rows and columns of a block)
constexpr int kTileM = 64;             // output rows per CTA: half a block-row
constexpr int kTileN = 64;             // channels per CTA
constexpr int kChunk = 32;             // depth per pipeline stage
constexpr int kStages = 3;             // ring of stages in shared memory
constexpr int kWarpsM = 2;             // warps along the rows of the CTA tile
constexpr int kWarpsN = 2;             // ... and along its channels
constexpr int kBsrThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWarpM = kTileM / kWarpsM;  // 32 rows per warp: 2 mma tiles of 16
constexpr int kWarpN = kTileN / kWarpsN;  // 32 channels per warp: 4 mma tiles of 8
constexpr int kMT = kWarpM / 16;
constexpr int kNT = kWarpN / 8;
constexpr int kAPitch = kChunk + 4;    // 36 floats: A fragment loads conflict-free
constexpr int kXPitch = kTileN + 8;    // 72 floats: B fragment loads conflict-free
constexpr int kAStage = kTileM * kAPitch;
constexpr int kXStage = kChunk * kXPitch;
constexpr int kBsrSmemBytes = kStages * (kAStage + kXStage) * static_cast<int>(sizeof(float));  // 55,296

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes if !full
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0));
}

// 4 bytes from global to shared, or 4 zero bytes if !full
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// v ~ hi + lo with hi and lo each a TF32 value: hi = rna(v), lo = rna(v - hi),
// rounding to nearest with ties away from zero as cvt.rna.tf32.f32 does for
// a finite value, but in two integer operations (half of the 13 dropped
// bits' unit added, then the 13 bits cleared): ptxas expands
// cvt.rna.tf32.f32 into a longer sequence that also tests for special values
// (an FSETP and a select in the SASS).  v - hi is exact in fp32.  Rounding lo to
// nearest rather than truncating it keeps its error unbiased: a truncated lo
// errs toward zero in every product, and a sum over thousands of rows
// downstream (a batch norm's statistics) adds that bias up.
__device__ __forceinline__ unsigned rna_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float v, unsigned& hi, unsigned& lo) {
  hi = rna_tf32(v);
  lo = rna_tf32(v - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col) in TF32 with fp32 accumulation.  Not
// volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool VEC4>
__global__ void __launch_bounds__(kBsrThreads)
bsr_spmm_kernel(const int* __restrict__ block_cols, const float* __restrict__ block_vals,
                const float* __restrict__ x, float* __restrict__ out,
                int nb, int kb, int n, int c) {
  extern __shared__ __align__(16) float smem[];
  float* a_ring = smem;                       // [kStages][kTileM][kAPitch]: block rows m, depth d
  float* x_ring = smem + kStages * kAStage;   // [kStages][kChunk][kXPitch]: depth d, channels

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const int wm = (warp / kWarpsN) * kWarpM;  // the warp's rows in the CTA tile
  const int wn = (warp % kWarpsN) * kWarpN;  // the warp's channels in the CTA tile
  const int c0 = blockIdx.x * kTileN;
  constexpr int kParts = kBs / kTileM;  // CTAs per block-row
  const int part = blockIdx.y % kParts;
  const long long i = blockIdx.y / kParts;
  const long long b = blockIdx.z;

  const int* cols_i = block_cols + (b * nb + i) * kb;
  const float* vals_i = block_vals + (b * nb + i) * kb * static_cast<long long>(kBs * kBs) + part * kTileM * kBs;
  const float* xb = x + b * n * static_cast<long long>(c);
  const int n_blocks = n / kBs;
  constexpr int kChunksPerSlot = kBs / kChunk;
  const int iters = kb * kChunksPerSlot;

  // Each thread's copies lie at fixed offsets from a stage's origin, the
  // same for every stage: rows a_m + u * kARowStep of the block chunk, depth
  // rows x_d + u * kXRowStep of the x chunk, one column each.  Only the two
  // source pointers change from stage to stage.
  constexpr int kAQuads = kChunk / 4;                   // 16-byte copies per row of a block chunk
  constexpr int kARowStep = kBsrThreads / kAQuads;
  constexpr int kXLanes = VEC4 ? kTileN / 4 : kTileN;  // copies per depth row of an x chunk
  constexpr int kXRowStep = kBsrThreads / kXLanes;
  static_assert(kBsrThreads % kAQuads == 0 && kTileM % kARowStep == 0, "block chunk copies");
  static_assert(kBsrThreads % kXLanes == 0 && kChunk % kXRowStep == 0, "x chunk copies");
  const int a_m = tid / kAQuads;
  const int a_q = (tid % kAQuads) * 4;
  const int x_d = tid / kXLanes;
  const int x_ch = (tid % kXLanes) * (VEC4 ? 4 : 1);  // channel within the tile
  const bool ch_live = c0 + x_ch < c;
  const float* a_thread = vals_i + a_m * kBs + a_q;
  const long long x_thread = static_cast<long long>(x_d) * c + (ch_live ? c0 + x_ch : 0);
  const long long x_step = static_cast<long long>(kXRowStep) * c;
  float* a_dst = a_ring + a_m * kAPitch + a_q;
  float* x_dst = x_ring + x_d * kXPitch + x_ch;

  // stage `it` (slot it / 4, depth chunk it % 4) into ring slot `buf`
  auto load = [&](int it, int buf) {
    const int s = it / kChunksPerSlot;
    const int d0 = (it % kChunksPerSlot) * kChunk;
    const int col = cols_i[s];
    const bool ok = col >= 0 && col < n_blocks;
    // a slot out of range copies nothing (zero fill), from valid addresses
    const float* a = ok ? a_thread + s * static_cast<long long>(kBs * kBs) + d0 : block_vals;
    float* as = a_dst + buf * kAStage;
#pragma unroll
    for (int u = 0; u < kTileM / kARowStep; ++u) cp_async16(as + u * kARowStep * kAPitch, a + u * kARowStep * kBs, ok);
    const float* xs = ok ? xb + static_cast<long long>(col * kBs + d0) * c + x_thread : x;
    const bool full = ok && ch_live;
    float* xd = x_dst + buf * kXStage;
#pragma unroll
    for (int u = 0; u < kChunk / kXRowStep; ++u) {
      if (VEC4) {
        cp_async16(xd + u * kXRowStep * kXPitch, xs + u * x_step, full);
      } else {
        cp_async4(xd + u * kXRowStep * kXPitch, xs + u * x_step, full);
      }
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < iters) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<kStages - 2>();  // stage `it` has landed (this thread's copies)
    __syncthreads();               // ... and every thread's; stage it-1 is free again
    const int next = it + kStages - 1;
    if (next < iters) load(next, next % kStages);
    cp_async_commit();

    const float* as = a_ring + (it % kStages) * kAStage;
    const float* xsm = x_ring + (it % kStages) * kXStage;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 8) {
      unsigned a_hi[kMT][4], a_lo[kMT][4], b_hi[kNT][2], b_lo[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        // A fragment: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
        const float* ap = as + (wm + mt * 16 + g) * kAPitch + kk + t;
        split_tf32(ap[0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32(ap[8 * kAPitch], a_hi[mt][1], a_lo[mt][1]);
        split_tf32(ap[4], a_hi[mt][2], a_lo[mt][2]);
        split_tf32(ap[8 * kAPitch + 4], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        // B fragment: b0 (k = t, n = g), b1 (k = t+4, n = g)
        const float* bp = xsm + (kk + t) * kXPitch + wn + nt * 8 + g;
        split_tf32(bp[0], b_hi[nt][0], b_lo[nt][0]);
        split_tf32(bp[4 * kXPitch], b_hi[nt][1], b_lo[nt][1]);
      }
      // the small products first, each pass over every tile before the
      // next, so that products into one accumulator are kMT * kNT apart
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], a_lo[mt], b_hi[nt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], a_hi[mt], b_lo[nt]);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_tf32(acc[mt][nt], a_hi[mt], b_hi[nt]);
    }
  }
  cp_async_wait<0>();

  // C fragment: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
  float* ob = out + (b * nb * kBs + i * kBs + part * kTileM) * static_cast<long long>(c);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + mt * 16 + g + h * 8;
        const int ch = c0 + wn + nt * 8 + 2 * t;
        float* p = ob + static_cast<long long>(m) * c + ch;
        const float v0 = acc[mt][nt][2 * h];
        const float v1 = acc[mt][nt][2 * h + 1];
        if (VEC4) {  // c % 4 == 0 and ch even: both channels live together, 8-byte aligned
          if (ch < c) *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          if (ch < c) p[0] = v0;
          if (ch + 1 < c) p[1] = v1;
        }
      }
}

// ---------------------------------------------------------------------------
// SDDMM at an ELL pattern:
//   out[b, r, k] = <a[b, r], b[b, cols[b, r, k]]> where vals[b, r, k] != 0, else 0
//
// Replaces surfacenetworks_tpu/sparse/pallas_kernels.py::_sddmm_call.
// Bound: bytes.  At R=N=7040, K=16, C=120 it reads a and b (3.4 MB each)
// and the pattern (0.9 MB) once and writes 0.45 MB: 8.1 MB, 0.0024 ms at
// 3.35 TB/s (4.7 MB, 0.0014 ms, where a and b are one tensor, as in the
// smoothness term).  As in ell_spmm_kernel, each row of b is gathered by
// every row that references it (about 7), so the L2 cache serves several
// times b's bytes, and a row's gathers are round trips to it.
//
// Design: one warp per row r, 16-byte lanes along the channel axis.  Dead
// slots cost nothing: each lane reads one (col, val) pair of the row's
// current 32 slots, and a ballot over val != 0 (and a column in [0, n))
// gives the live slots as a mask, walked in slot order wherever the padding
// sits.  They are taken in chunks of kSddmmChunk: the warp learns the
// chunk's columns by shuffles, issues all its gathers of b[col] into
// registers and only then forms each lane's partial dots, one per slot.  A
// transposing reduction sums them over the warp: each xor step hands half
// of a lane's values to its partner and adds the half it keeps, so a chunk
// of 4 costs 2 + 1 + 1 + 1 + 1 = 6 shuffles where a butterfly per slot costs
// 20, and slot i's dot lands in lane 8 i, from where its own lane takes it;
// the row's K outputs leave in one coalesced store.  It adds the same pairs
// of lanes in the same tree as a butterfly, so its sums have a butterfly's
// bits.  Channels past the first 128 (C > 128) take further passes over the
// same chunks, each adding its reduced dots to the outputs, so nothing is
// held across passes.  Every output is summed in one fixed order without
// atomics: two launches on the same inputs agree bit for bit.  Padding
// slots give exactly 0; a column outside [0, n) gives 0 and is never read (a
// guard only: the host range-checks the pattern).
//
// Chunks of 4 rather than 8, and blocks of 4 warps rather than 8: at 48
// registers 40 warps fit on an SM, and rows in flight matter more here than
// gathers in flight per row (chunks of 8 need 64 registers and ran slower;
// so did blocks of 8 warps).
//
// Measured by chip_smoke.py at R=N=7040, K=16, C=120 on an NVIDIA H100 80GB
// HBM3 at 700.00 W: 0.00728 ms warm (33% of the byte bound), 0.01229 ms with
// a cold L2 cache; 48 registers, no spills.  The L2 cache then serves about
// 28 MB (b's rows gathered ~7 times each, a, the pattern), 3.9 TB/s, about
// what ell_spmm_kernel reaches on the same gathers: that rate, not the byte
// bound, is what holds the kernel.
// ---------------------------------------------------------------------------
constexpr int kSddmmChunk = 4;      // live slots whose gathers are in flight together
constexpr int kSddmmThreads = 128;  // 4 warps, one row each

__device__ __forceinline__ float dot4(float4 u, float4 v) {
  return fmaf(u.x, v.x, fmaf(u.y, v.y, fmaf(u.z, v.z, u.w * v.w)));
}

// Sums each of v[0..N) over a group of G lanes (G and N powers of 2, N <= G
// <= 32; a group is G aligned lanes of the warp, and every lane of the warp
// takes part); on return lane l holds the sum of v[(l % G) / (G / N)] over
// its group.  Each of the first log2 N steps keeps half of a lane's values,
// adds the partner's matching half and hands its other half on; the rest is
// a butterfly on one value.  Every partner is in the lane's own group.
template <int N, int G = 32>
__device__ __forceinline__ float transposing_sum(float (&v)[N], int lane) {
  static_assert(N <= G && G <= 32, "N values over G lanes");
  int off = G / 2;
#pragma unroll
  for (int h = N / 2; h >= 1; h /= 2, off /= 2) {
    const bool upper = lane & off;  // this lane keeps v[h, 2h), its partner v[0, h)
#pragma unroll
    for (int i = 0; i < h; ++i) {
      v[i] = (upper ? v[i + h] : v[i]) + __shfl_xor_sync(0xffffffffu, upper ? v[i] : v[i + h], off);
    }
  }
#pragma unroll
  for (; off >= 1; off /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  return v[0];
}

template <bool VEC4>
__global__ void __launch_bounds__(kSddmmThreads, 8)
sddmm_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
             const float* __restrict__ a, const float* __restrict__ b,
             float* __restrict__ out, int batch, int rows, int k, int n, int c) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (kSddmmThreads / 32) + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(batch) * rows) return;  // whole warp leaves together
  const long long bi = row / rows;
  const int* row_cols = cols + row * k;
  const float* row_vals = vals + row * k;
  const float* arow = a + row * c;
  const float* bb = b + bi * n * static_cast<long long>(c);
  float* orow = out + row * k;

  const int width = VEC4 ? c / 4 : c;  // channel axis in units of float4 or float
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s0 = 0; s0 < k; s0 += 32) {
    const int ns = min(32, k - s0);
    int my_col = 0;
    float my_val = 0.f;
    if (lane < ns) {
      my_col = row_cols[s0 + lane];
      my_val = row_vals[s0 + lane];
    }
    const bool my_live = my_val != 0.f && my_col >= 0 && my_col < n;
    const unsigned live_slots = __ballot_sync(0xffffffffu, my_live);
    const int n_live = __popc(live_slots);
    const int my_rank = __popc(live_slots & ((1u << lane) - 1u));  // live slots before mine
    float my_out = 0.f;
    for (int j0 = 0; j0 < width; j0 += 32) {
      const int j = j0 + lane;
      const bool live = j < width;
      unsigned todo = live_slots;
      for (int r0 = 0; r0 < n_live; r0 += kSddmmChunk) {
        // every gather of the chunk in flight before any product
        float4 bv[kSddmmChunk];
#pragma unroll
        for (int i = 0; i < kSddmmChunk; ++i) {
          const int s = todo ? __ffs(todo) - 1 : 0;  // live slot r0 + i, if any
          todo &= todo - 1;
          const int col = __shfl_sync(0xffffffffu, my_col, s);
          bv[i] = live && r0 + i < n_live ? load4<VEC4>(bb + static_cast<long long>(col) * c, j) : zero;
        }
        const float4 av = live ? load4<VEC4>(arow, j) : zero;
        float part[kSddmmChunk];
#pragma unroll
        for (int i = 0; i < kSddmmChunk; ++i) part[i] = dot4(av, bv[i]);
        const float dot = transposing_sum(part, lane);  // live slot r0 + i's dot in lane i * 32 / kSddmmChunk
        const int i = my_rank - r0;
        const float mine = __shfl_sync(0xffffffffu, dot, (i & (kSddmmChunk - 1)) * (32 / kSddmmChunk));
        if (my_live && i >= 0 && i < kSddmmChunk) my_out += mine;
      }
    }
    if (lane < ns) orow[s0 + lane] = my_out;
  }
}

// ---------------------------------------------------------------------------
// bf16 helpers
// ---------------------------------------------------------------------------

// bf16 bits -> fp32, exact: the bf16 value is the high half of the fp32 word
__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

// fp32 -> bf16 bits, rounded to nearest even (NaN stays NaN)
__device__ __forceinline__ unsigned short bf16_rn(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// 8 bf16 (a 16-byte load) widened into v[0..8)
__device__ __forceinline__ void widen8(const uint4& q, float (&v)[8]) {
  v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x);
  v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
  v[4] = bf16_lo(q.z); v[5] = bf16_hi(q.z);
  v[6] = bf16_lo(q.w); v[7] = bf16_hi(q.w);
}

// VEC8: the j-th group of 8 bf16 of a row (16 bytes) in q; else the j-th
// bf16 in the low half of q.x
template <bool VEC8>
__device__ __forceinline__ uint4 load_bf(const unsigned short* p, int j) {
  if (VEC8) return reinterpret_cast<const uint4*>(p)[j];
  return make_uint4(static_cast<unsigned>(p[j]), 0u, 0u, 0u);
}

// ---------------------------------------------------------------------------
// Scalar-ELL SpMM on bf16 x: fp32 vals, bf16 x, fp32 out
//   out[b, r] = sum_k vals[b, r, k] * x[b, cols[b, r, k]]
//
// Replaces _ell_matmul_call's bf16-x use (pallas_kernels.py:186-274) as the
// JAX trainers run it, _ell_matmul_xla: fp32 vals times bf16 x promote to
// fp32, the sum is fp32 and so is the result.  Bound: bytes, as in
// ell_spmm_kernel, with x's bytes halved; like it, the kernel is held back by
// the round trips of its gathers to the L2 cache, so what sets its pace is
// the bytes each resident warp keeps in flight.
//
// Design: a lane carries 8 bf16 channels (one 16-byte load, widened to fp32
// in registers; 1 channel on the scalar path, C % 8 != 0), and a warp holds
// 32 / lanes_per_row output rows, lanes_per_row being the row's lanes
// rounded up to a power of two (at most 32): 2 rows per warp at C = 120-128,
// 4 at C = 64, 32 at C = 8; one row per warp with channel passes past 256
// channels.  So a warp's gathers of one slot fill its 32 lanes (512 bytes at
// C = 128, as ell_spmm_kernel's are).  Each lane group reads its own row's (col, val) chunk (16-byte pair
// loads where pairs4 allows), issues the chunk's kEllChunk gathers into
// registers, each predicated on a live slot and an in-range column, and only
// then does the FMAs.  No shuffle or ballot crosses lane groups, so a group
// past the last row just leaves.  Every channel adds its slots in slot order
// with fmaf, the order ell_spmm_kernel uses, whatever the rows per warp:
// two launches agree bit for bit.  At
// most 64 registers (__launch_bounds__(256, 4)): 4 CTAs of 8 warps resident.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700.00 W: at
// R=N=7040, K=16, C=128 0.00620 ms warm (30% of its 0.00188 ms byte bound),
// 0.00975 ms cold (the fp32 kernel: 0.00695 warm); 0.0354 ms at the ARAP
// batch (32 x 2,000 rows, C=128) and 0.0062 ms at the mesh-MNIST batch (64 x
// 216 rows, C=64).  64 registers (52 on the scalar path), no spills.
// ---------------------------------------------------------------------------
template <bool VEC8>
__global__ void __launch_bounds__(256, 4)
ell_spmm_bf16x_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                      const unsigned short* __restrict__ x, float* __restrict__ out,
                      int batch, int rows, int k, int n, int c, int pairs4, int lanes_log2) {
  const int lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const long long row = (warp << (5 - lanes_log2)) + (lane >> lanes_log2);
  if (row >= static_cast<long long>(batch) * rows) return;  // the lane group past the last row leaves
  const long long b = row / rows;
  const int* row_cols = cols + row * k;
  const float* row_vals = vals + row * k;
  const unsigned short* xb = x + b * n * static_cast<long long>(c);
  float* orow = out + row * c;
  constexpr int kW = VEC8 ? 8 : 1;  // channels per lane and pass
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // the lane's units of the channel axis (8 bf16, or one): a lane past the
  // row's width has none, and nothing it skips is shared with another lane
  const int width = VEC8 ? c / 8 : c;
  for (int j = lane & ((1 << lanes_log2) - 1); j < width; j += 1 << lanes_log2) {
    float acc[kW];
#pragma unroll
    for (int i = 0; i < kW; ++i) acc[i] = 0.f;
    for (int s0 = 0; s0 < k; s0 += kEllChunk) {
      int col[kEllChunk];
      float val[kEllChunk];
      if (pairs4 && s0 + kEllChunk <= k) {
#pragma unroll
        for (int q = 0; q < kEllChunk / 4; ++q) {
          const int4 cq = __ldg(reinterpret_cast<const int4*>(row_cols + s0) + q);
          const float4 vq = __ldg(reinterpret_cast<const float4*>(row_vals + s0) + q);
          col[4 * q + 0] = cq.x; col[4 * q + 1] = cq.y; col[4 * q + 2] = cq.z; col[4 * q + 3] = cq.w;
          val[4 * q + 0] = vq.x; val[4 * q + 1] = vq.y; val[4 * q + 2] = vq.z; val[4 * q + 3] = vq.w;
        }
      } else {
#pragma unroll
        for (int s = 0; s < kEllChunk; ++s) {
          const bool in = s0 + s < k;
          col[s] = in ? __ldg(row_cols + s0 + s) : 0;
          val[s] = in ? __ldg(row_vals + s0 + s) : 0.f;
        }
      }
      // every gather of the chunk in flight before any FMA
      uint4 xv[kEllChunk];
#pragma unroll
      for (int s = 0; s < kEllChunk; ++s) {
        const bool take = val[s] != 0.f && col[s] >= 0 && col[s] < n;
        val[s] = take ? val[s] : 0.f;
        xv[s] = take ? load_bf<VEC8>(xb + static_cast<long long>(col[s]) * c, j) : zero;
      }
#pragma unroll
      for (int s = 0; s < kEllChunk; ++s) {
        if constexpr (VEC8) {
          float w[8];
          widen8(xv[s], w);
#pragma unroll
          for (int i = 0; i < kW; ++i) acc[i] = fmaf(val[s], w[i], acc[i]);
        } else {
          acc[0] = fmaf(val[s], bf16_lo(xv[s].x), acc[0]);
        }
      }
    }
    if constexpr (VEC8) {  // c % 8 == 0 and out 16-byte aligned: two float4 stores
      float4* o = reinterpret_cast<float4*>(orow) + 2 * j;
      o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    } else {
      orow[j] = acc[0];
    }
  }
}

// ---------------------------------------------------------------------------
// Block-ELL SpMM over 128x128 bf16 blocks on the tensor cores:
//   out[b, i*128 + m, ch] = sum_s sum_j vals[b, i, s, m, j] * bf16(x[b, cols[b, i, s]*128 + j, ch])
//
// Replaces _bsr_matmul_call's bf16-block use (pallas_kernels.py:133-178) as
// the JAX trainers run it, _bsr_matmul_xla (sparse/bsr.py:145-160): x is
// rounded to bf16 (to nearest even), the bf16 x bf16 products are summed in
// fp32 and the result is fp32.  x may be fp32 (the backward's cotangent) or
// bf16 (the forward's activations).  One bf16 tensor-core pass is exact per
// product (8-bit by 8-bit mantissas fit fp32), where fp32 operands need
// three TF32 passes.  Bound: bytes.  At NB=55, KB=5, C=128 the stored blocks
// are 9 MB, bf16 x 1.8 MB (fp32 3.6 MB), the fp32 out 3.6 MB: 14.4 MB, 0.0043
// ms at 3.35 TB/s; its 1.15 GFLOP take 0.0012 ms at 989 TFLOP/s.
//
// A CTA that waits on each depth chunk before it loads the next is paced by
// a global round trip per chunk (20 per CTA at KB=5), not by bytes or
// operations.  So:
//
// * Tiling: one CTA of 4 warps per (64-row half of a block-row, 64-channel
//   tile, batch item), each warp a 32 x 32 fp32 tile in registers (mma.sync
//   m16n8k16 bf16, row.col, fp32 accumulate).  At NB=55, C=128 that is 220
//   CTAs of 128 threads on the 132 SMs, up to two on an SM.  Each stored
//   block is read once per channel tile: about 11.2 MB of live block chunks
//   and 11.2 MB of bf16 x slices (22.3 MB fp32) cross L2, about 100 KB per
//   CTA.  128-channel tiles (110 CTAs of 8 warps) read each block once, 5.6
//   MB, but took 1.12x the time on bf16 x and 1.10x on fp32 x
//   (bsr_bf16_sweep.py): a CTA's time is the chain of its live chunks, and
//   a wider tile makes each link longer.
// * A ring of kBfStages = 6 depth chunks of 32 in dynamic shared memory,
//   filled by 16-byte cp.async from both operands: five chunks in flight
//   while one multiplies.  The block chunk is 64 rows x 32 bf16 (rows of 40
//   bf16, 80 bytes); x keeps its own row-major layout, 32 depths x 64
//   channels (rows of 72 bf16, 144 bytes), and its B fragments come from
//   ldmatrix.x4.trans, the A fragments from ldmatrix.x4; both pitches put
//   the 8 rows of each 8x8 matrix in distinct bank groups.  Shared memory:
//   6 x (5,120 + 4,608) = 58,368 bytes on bf16 x.
// * fp32 x (the backward's cotangent) is staged as fp32 (rows of 68
//   floats, 6 x (5,120 + 8,704) = 82,944 bytes) and rounded to bf16 to
//   nearest even (cvt.rn.bf16x2.f32) as each B fragment is built from two
//   conflict-free 4-byte reads per register: no separate rounding pass.
// * Dead chunks are skipped: ``live`` (uint8 [batch, nb, kb], or null for
//   "all live") has bit 4 h + d set where rows 64 h .. 64 h + 63, depths
//   32 d .. 32 d + 31 of the slot's stored block hold a nonzero (built once
//   per operator on the host, sparse/bsr.py::live_chunks).  About 38% of a
//   mesh Laplacian's stored chunks are zero; they, padding slots and block
//   columns outside [0, n/128) are neither loaded nor multiplied.  A chunk
//   of zero A adds exact zeros, so finite results are those of reading it.
// * The chunks are taken in slot order, each chunk's two k16 steps in depth
//   order: every output element sees its mma.sync steps in that order,
//   whatever the tiling across warps and CTAs, so the bits depend neither
//   on the tiling nor on the mask, and two launches agree bit for bit.
// * C % 8 != 0 (bf16 x) or C % 4 != 0 (fp32 x), or x not 16-byte aligned:
//   the VEC = false variant stages x element by element (fp32: 4-byte
//   cp.async; bf16: plain loads), zero-filling past the channel edge.
//
// Measured by bsr_bf16_sweep.py at NB=55, KB=5, C=128 (1,364 of the 2,200
// stored chunks live; a CTA takes 2-16, median 13) on an NVIDIA H100 80GB
// HBM3 at 700.00 W: 0.0102 ms warm on bf16 x, 32% of the 0.00328 ms its
// live chunks, the x slices they read and out take at 3.35 TB/s; 0.0126-
// 0.0128 ms on fp32 x (bound 0.00382); 0.0144-0.0146 ms cold; every chunk
// read (no mask): 0.0127 ms, 34% of the 0.0043 ms of every stored byte.
// 3 to 8 stages time within 3% of each other, 2 stages 1.07x: the busiest
// CTAs' 16 live chunks, about 0.64 us each with a barrier each, set the
// pace, not the latency of a load.
// ---------------------------------------------------------------------------
// The channel tile and the ring's depth can be set at build time
// (-DSNX_BF_TILE_N=128, -DSNX_BF_STAGES=4) only to measure the design's
// parts one by one (bsr_bf16_sweep.py); the port builds the defaults.
#ifndef SNX_BF_TILE_N
#define SNX_BF_TILE_N 64
#endif
#ifndef SNX_BF_STAGES
#define SNX_BF_STAGES 6
#endif
constexpr int kBfTileN = SNX_BF_TILE_N;               // channels per CTA
constexpr int kBfWarpsN = kBfTileN / kWarpN;          // 2 warps along the channels, kWarpsM = 2 along the rows
constexpr int kBfThreads = 32 * kWarpsM * kBfWarpsN;  // 128
constexpr int kBfChunk = 32;                          // depth per stage, and per bit of the live mask
constexpr int kBfStages = SNX_BF_STAGES;              // ring of stages in shared memory
static_assert((kBfTileN == 64 || kBfTileN == 128) && kBfStages >= 2, "bf16 BSR tiling");
constexpr int kBfAPitch = kBfChunk + 8;               // 40 bf16 per shared row of a block chunk
constexpr int kBfXPitch = kBfTileN + 8;               // 72 bf16 per shared row of a bf16 x chunk
constexpr int kBfXPitchF = kBfTileN + 4;              // 68 floats per shared row of an fp32 x chunk
constexpr int kBfAStageBytes = kTileM * kBfAPitch * 2;                // 5,120
constexpr int kBfXStageBytes16 = kBfChunk * kBfXPitch * 2;            // 4,608
constexpr int kBfXStageBytes32 = kBfChunk * kBfXPitchF * 4;           // 8,704
static_assert(kBs / kTileM == 2 && kBs / kBfChunk == 4, "live-mask bits: 2 halves x 4 depth chunks");

// d += a (16x16, row) * b (16x8, col) in bf16 with fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared, or 16 zero bytes if !full
__device__ __forceinline__ void cp_async16b(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(full ? 16 : 0));
}

// four 8x8 bf16 matrices from shared memory, lanes 8q..8q+7 giving the row
// addresses of matrix q; .trans hands each thread the transposed matrices'
// elements
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// two fp32 rounded to bf16 to nearest even and packed, lo in the low half
__device__ __forceinline__ unsigned pack_bf16_rn(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

template <bool XBF16, bool VEC>
__global__ void __launch_bounds__(kBfThreads, 1)
bsr_spmm_bf16_kernel(const int* __restrict__ block_cols, const unsigned short* __restrict__ block_vals,
                     const unsigned char* __restrict__ live, const void* __restrict__ x, float* __restrict__ out,
                     int nb, int kb, int n, int c) {
  constexpr int kXStageBytes = XBF16 ? kBfXStageBytes16 : kBfXStageBytes32;
  extern __shared__ __align__(16) unsigned char bf_smem[];
  unsigned char* a_ring = bf_smem;                                // [stage][row m][depth] bf16
  unsigned char* x_ring = bf_smem + kBfStages * kBfAStageBytes;   // [stage][depth][channel] bf16 or fp32
  int* slot_info = reinterpret_cast<int*>(x_ring + kBfStages * kXStageBytes);  // [kb]: column | live bits << 24

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma groupID
  const int t = lane & 3;   // mma threadID_in_group
  const int wm = (warp / kBfWarpsN) * kWarpM;  // the warp's rows in the CTA tile
  const int wn = (warp % kBfWarpsN) * kWarpN;  // the warp's channels in the CTA tile
  const int c0 = blockIdx.x * kBfTileN;
  const int part = blockIdx.y & 1;  // which 64-row half of the block-row
  const long long bi = static_cast<long long>(blockIdx.z) * nb + (blockIdx.y >> 1);  // batch item and block-row
  constexpr int kXBytes = XBF16 ? 2 : 4;

  const int* cols_i = block_cols + bi * kb;
  const unsigned short* vals_i = block_vals + bi * kb * static_cast<long long>(kBs * kBs) + part * kTileM * kBs;
  const char* xb = static_cast<const char*>(x) + static_cast<long long>(blockIdx.z) * n * static_cast<long long>(c) * kXBytes;
  const int n_blocks = n / kBs;

  // the block-row's slots: column and this half's four live bits (none for
  // a column out of range)
  for (int s = tid; s < kb; s += kBfThreads) {
    const int col = cols_i[s];
    const bool ok = col >= 0 && col < n_blocks;
    const int bits = !ok ? 0 : live ? (live[bi * kb + s] >> (4 * part)) & 15 : 15;
    slot_info[s] = (ok ? col : 0) | (bits << 24);
  }
  __syncthreads();
  int n_live = 0;
  for (int s = 0; s < kb; ++s) n_live += __popc(slot_info[s] >> 24);

  // items p = 4 s + d (slot s, depth chunk d) in order; the producer's
  // cursor skips the dead ones
  const int items = 4 * kb;
  int p = 0;
  auto next_live = [&]() {
    while (p < items && !((slot_info[p >> 2] >> (24 + (p & 3))) & 1)) ++p;
  };
  // item p into ring stage st
  auto load = [&](int st) {
    const int s = p >> 2;
    const int d0 = (p & 3) * kBfChunk;
    const long long xrow = static_cast<long long>(slot_info[s] & 0xffffff) * kBs + d0;  // x's first row in the chunk
#pragma unroll
    for (int u = 0; u < kTileM * 4 / kBfThreads; ++u) {  // block chunk: 64 rows x 4 pieces of 16 bytes
      const unsigned id = tid + u * kBfThreads;  // unsigned: / and % by powers of two are shifts
      const int m = id >> 2;
      const int q = (id & 3) * 8;
      cp_async16b(a_ring + st * kBfAStageBytes + (m * kBfAPitch + q) * 2,
                  vals_i + s * static_cast<long long>(kBs * kBs) + m * kBs + d0 + q, true);
    }
    unsigned char* xs = x_ring + st * kXStageBytes;
    if constexpr (XBF16 && VEC) {  // 32 depths x kBfTileN / 8 pieces of 8 channels
      const unsigned short* xp = reinterpret_cast<const unsigned short*>(xb);
#pragma unroll
      for (int u = 0; u < kBfChunk * kBfTileN / 8 / kBfThreads; ++u) {
        const unsigned id = tid + u * kBfThreads;
        const int d = id / (kBfTileN / 8);
        const int cl = id % (kBfTileN / 8) * 8;
        const bool full = c0 + cl < c;
        cp_async16b(xs + (d * kBfXPitch + cl) * 2, full ? xp + (xrow + d) * c + c0 + cl : xp, full);
      }
    } else if constexpr (XBF16) {  // element by element, plain loads
      const unsigned short* xp = reinterpret_cast<const unsigned short*>(xb);
      constexpr int kU = kBfChunk * kBfTileN / kBfThreads;  // 16
      unsigned short v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const unsigned id = tid + u * kBfThreads;
        const int ch = c0 + id % kBfTileN;
        v[u] = ch < c ? xp[(xrow + id / kBfTileN) * c + ch] : static_cast<unsigned short>(0);
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const unsigned id = tid + u * kBfThreads;
        reinterpret_cast<unsigned short*>(xs)[id / kBfTileN * kBfXPitch + id % kBfTileN] = v[u];
      }
    } else if constexpr (VEC) {  // fp32: 32 depths x kBfTileN / 4 pieces of 4 channels
      const float* xp = reinterpret_cast<const float*>(xb);
      float* xf = reinterpret_cast<float*>(xs);
#pragma unroll
      for (int u = 0; u < kBfChunk * kBfTileN / 4 / kBfThreads; ++u) {
        const unsigned id = tid + u * kBfThreads;
        const int d = id / (kBfTileN / 4);
        const int cl = id % (kBfTileN / 4) * 4;
        const bool full = c0 + cl < c;
        cp_async16(xf + d * kBfXPitchF + cl, full ? xp + (xrow + d) * c + c0 + cl : xp, full);
      }
    } else {  // fp32, element by element
      const float* xp = reinterpret_cast<const float*>(xb);
      float* xf = reinterpret_cast<float*>(xs);
#pragma unroll
      for (int u = 0; u < kBfChunk * kBfTileN / kBfThreads; ++u) {
        const unsigned id = tid + u * kBfThreads;
        const int d = id / kBfTileN;
        const int cl = id % kBfTileN;
        const bool full = c0 + cl < c;
        cp_async4(xf + d * kBfXPitchF + cl, full ? xp + (xrow + d) * c + c0 + cl : xp, full);
      }
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mt][nt][r] = 0.f;

  // one commit group per stage, empty once the live items run out: live
  // item q sits in stage q % kBfStages
  int st_load = 0;
#pragma unroll 1
  for (int st = 0; st < kBfStages - 1; ++st) {
    next_live();
    if (p < items) {
      load(st_load);
      ++p;
    }
    cp_async_commit();
    ++st_load;
  }
  int st_use = 0;
#pragma unroll 1
  for (int q = 0; q < n_live; ++q) {
    cp_async_wait<kBfStages - 2>();  // live item q has landed (this thread's copies)
    __syncthreads();                 // ... and every thread's; stage q-1 is free again
    next_live();
    if (p < items) {
      load(st_load);
      ++p;
    }
    cp_async_commit();
    st_load = st_load + 1 == kBfStages ? 0 : st_load + 1;

    const unsigned short* as = reinterpret_cast<const unsigned short*>(a_ring + st_use * kBfAStageBytes);
    const unsigned char* xs = x_ring + st_use * kXStageBytes;
#pragma unroll
    for (int kk = 0; kk < kBfChunk; kk += 16) {
      unsigned af[kMT][4], bfr[kNT][2];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        // a0 (rows 0-7, depths 0-7), a1 (rows 8-15), a2 (depths 8-15), a3
        ldmatrix_x4(af[mt], as + (wm + mt * 16 + (lane & 15)) * kBfAPitch + kk + (lane >> 4) * 8);
      }
      if constexpr (XBF16) {
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          // b0, b1 of channel tile 2 np, then of 2 np + 1: depths kk..kk+7 and
          // kk+8..kk+15 of 8 channels each, transposed
          unsigned r[4];
          ldmatrix_x4_trans(r, reinterpret_cast<const unsigned short*>(xs) +
                                   (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kBfXPitch + wn + np * 16 +
                                   (lane >> 4) * 8);
          bfr[2 * np][0] = r[0];
          bfr[2 * np][1] = r[1];
          bfr[2 * np + 1][0] = r[2];
          bfr[2 * np + 1][1] = r[3];
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          // b0 (depths 2t, 2t+1 of channel g), b1 (depths 2t+8, 2t+9), rounded here
          const float* bp = reinterpret_cast<const float*>(xs) + (kk + 2 * t) * kBfXPitchF + wn + nt * 8 + g;
          bfr[nt][0] = pack_bf16_rn(bp[0], bp[kBfXPitchF]);
          bfr[nt][1] = pack_bf16_rn(bp[8 * kBfXPitchF], bp[9 * kBfXPitchF]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
    }
    st_use = st_use + 1 == kBfStages ? 0 : st_use + 1;
  }
  cp_async_wait<0>();

  // C fragment: c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1)
  float* ob = out + (bi * kBs + part * kTileM) * static_cast<long long>(c);
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + mt * 16 + g + h * 8;
        const int ch = c0 + wn + nt * 8 + 2 * t;
        float* o = ob + static_cast<long long>(m) * c + ch;
        const float v0 = acc[mt][nt][2 * h];
        const float v1 = acc[mt][nt][2 * h + 1];
        if (VEC) {  // c even and ch even: both channels live together, 8-byte aligned
          if (ch < c) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (ch < c) o[0] = v0;
          if (ch + 1 < c) o[1] = v1;
        }
      }
}

// one variant of bsr_spmm_bf16_kernel, its dynamic shared memory allowed
// before each launch (as for bsr_spmm_kernel)
template <bool XBF16, bool VEC>
cudaError_t launch_bsr_bf16(dim3 grid, int smem, cudaStream_t s, const int* bc, const unsigned short* bv,
                            const unsigned char* live, const void* x, float* o, int nb, int kb, int n, int c) {
  const cudaError_t e =
      cudaFuncSetAttribute(bsr_spmm_bf16_kernel<XBF16, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  bsr_spmm_bf16_kernel<XBF16, VEC><<<grid, kBfThreads, smem, s>>>(bc, bv, live, x, o, nb, kb, n, c);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// SDDMM of bf16 features at an ELL pattern, bf16 out:
//   out[b, r, k] = bf16(<a[b, r], b[b, cols[b, r, k]]>) where vals[b, r, k] != 0, else 0
//
// Replaces _sddmm_call's bf16 use (pallas_kernels.py:277-352) as the JAX
// trainers run it, _sddmm_xla: bf16 a and b, the dot summed in fp32, one
// rounding to bf16 (to nearest even) at the store.  Bound: bytes, as in
// sddmm_kernel, with a, b and the output at half the bytes.  Design:
// sddmm_kernel's (a ballot over the row's slots, chunks of 4 live slots with
// their gathers in flight, one transposing reduction per chunk), with a
// 16-byte lane carrying 8 bf16 channels widened to fp32 in registers, and a
// row on G lanes, not on the whole warp: G is the row's 16-byte lanes (c / 8,
// or c on the scalar path) rounded up to a power of two, at least
// kSddmmChunk (the reduction's first steps stay inside the group) and at
// most 32, so a warp holds 32 / G rows: 2 at C=120 (15 lanes of loads, where
// one row a warp left 17 of 32 lanes idle), 4 at C=64.  A group takes its
// row's slots G at a time; its ballot bits, ranks and shuffles stay in the
// group (shuffles of width G), and the warp runs as many chunks as its
// fullest group needs (a group past its own live slots, or past the last
// row, loads nothing and adds zeros), so every shuffle has the whole warp.
//
// Bits: the 32-lane tree restricted to a row's G lanes is the G-lane tree
// (the levels above G only added exact zeros, and a -0 sum cannot show:
// the output starts at +0), so the output equals the one-row-a-warp
// design's bit for bit at every shape.  One fixed order of summation: two
// launches agree bit for bit.
//
// Measured by chip_smoke.py and sddmm_bf16_check.py at R=N=7040, K=16,
// C=120 on an NVIDIA H100 80GB HBM3 at 700.00 W: 0.0059 ms warm (23% of its
// 0.00134 ms byte bound; the one-row-a-warp design 0.0081 in the same
// calls, the fp32 kernel 0.0073), 0.0100 ms cold; 55 registers (39 on the
// scalar path), no spills.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float dot8(const uint4& u, const uint4& v) {
  float a[8], b[8];
  widen8(u, a);
  widen8(v, b);
  return fmaf(a[0], b[0], fmaf(a[1], b[1], fmaf(a[2], b[2], fmaf(a[3], b[3],
         fmaf(a[4], b[4], fmaf(a[5], b[5], fmaf(a[6], b[6], a[7] * b[7])))))));
}

template <bool VEC8, int G>
__global__ void __launch_bounds__(kSddmmThreads, 8)
sddmm_bf16_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                  const unsigned short* __restrict__ a, const unsigned short* __restrict__ b,
                  unsigned short* __restrict__ out, int batch, int rows, int k, int n, int c) {
  static_assert(G >= kSddmmChunk && G <= 32 && (G & (G - 1)) == 0, "lanes per row");
  const int lane = threadIdx.x & 31;
  const int sub = lane & (G - 1);  // the lane's place in its row's group
  const long long total = static_cast<long long>(batch) * rows;
  const long long first =
      (static_cast<long long>(blockIdx.x) * (kSddmmThreads / 32) + (threadIdx.x >> 5)) * (32 / G);
  if (first >= total) return;  // whole warp leaves together
  const bool row_in = first + lane / G < total;  // a group past the last row loads and stores nothing
  const long long row = row_in ? first + lane / G : first;
  const long long bi = row / rows;
  const int* row_cols = cols + row * k;
  const float* row_vals = vals + row * k;
  const unsigned short* arow = a + row * c;
  const unsigned short* bb = b + bi * n * static_cast<long long>(c);
  unsigned short* orow = out + row * k;

  const int width = VEC8 ? c / 8 : c;  // channel axis in units of 8 bf16 or one
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int s0 = 0; s0 < k; s0 += G) {
    const int ns = min(G, k - s0);
    int my_col = 0;
    float my_val = 0.f;
    if (row_in && sub < ns) {
      my_col = row_cols[s0 + sub];
      my_val = row_vals[s0 + sub];
    }
    const bool my_live = my_val != 0.f && my_col >= 0 && my_col < n;
    unsigned live_slots = __ballot_sync(0xffffffffu, my_live);
    if constexpr (G < 32) live_slots = (live_slots >> (lane & ~(G - 1))) & ((1u << G) - 1u);  // the group's bits
    const int n_live = __popc(live_slots);
    const int my_rank = __popc(live_slots & ((1u << sub) - 1u));  // live slots before mine
    int warp_live = n_live;  // the chunks the warp runs: its fullest group's
    if constexpr (G < 32) warp_live = static_cast<int>(__reduce_max_sync(0xffffffffu, static_cast<unsigned>(n_live)));
    float my_out = 0.f;
    for (int j0 = 0; j0 < width; j0 += G) {
      const int j = j0 + sub;
      const bool live = row_in && j < width;
      unsigned todo = live_slots;
      for (int r0 = 0; r0 < warp_live; r0 += kSddmmChunk) {
        // every gather of the chunk in flight before any product
        uint4 bv[kSddmmChunk];
#pragma unroll
        for (int q = 0; q < kSddmmChunk; ++q) {
          const int s = todo ? __ffs(todo) - 1 : 0;  // live slot r0 + q of the group, if any
          todo &= todo - 1;
          const int col = __shfl_sync(0xffffffffu, my_col, s, G);
          bv[q] = live && r0 + q < n_live ? load_bf<VEC8>(bb + static_cast<long long>(col) * c, j) : zero;
        }
        const uint4 av = live ? load_bf<VEC8>(arow, j) : zero;
        float part[kSddmmChunk];
#pragma unroll
        for (int q = 0; q < kSddmmChunk; ++q) {
          part[q] = VEC8 ? dot8(av, bv[q]) : bf16_lo(av.x) * bf16_lo(bv[q].x);
        }
        // live slot r0 + q's dot in the group's lane q * G / kSddmmChunk
        const float dot = transposing_sum<kSddmmChunk, G>(part, lane);
        const int q = my_rank - r0;
        const float mine = __shfl_sync(0xffffffffu, dot, (q & (kSddmmChunk - 1)) * (G / kSddmmChunk), G);
        if (my_live && q >= 0 && q < kSddmmChunk) my_out += mine;
      }
    }
    if (row_in && sub < ns) orow[s0 + sub] = bf16_rn(my_out);
  }
}

// the lanes a row of c channels takes in sddmm_bf16_kernel: its 16-byte
// lanes (or its channels on the scalar path) rounded up to a power of two,
// at least kSddmmChunk, at most 32
int sddmm_bf16_lanes(int c, bool vec8) {
  const int width = vec8 ? c / 8 : c;
  int g = kSddmmChunk;
  while (g < 32 && g < width) g *= 2;
  return g;
}

template <bool VEC8>
void launch_sddmm_bf16(int g, unsigned blocks, cudaStream_t s, const int* cc, const float* vv,
                       const unsigned short* aa, const unsigned short* bb, unsigned short* o,
                       int batch, int rows, int k, int n, int c) {
  switch (g) {
    case 4: sddmm_bf16_kernel<VEC8, 4><<<blocks, kSddmmThreads, 0, s>>>(cc, vv, aa, bb, o, batch, rows, k, n, c); break;
    case 8: sddmm_bf16_kernel<VEC8, 8><<<blocks, kSddmmThreads, 0, s>>>(cc, vv, aa, bb, o, batch, rows, k, n, c); break;
    case 16: sddmm_bf16_kernel<VEC8, 16><<<blocks, kSddmmThreads, 0, s>>>(cc, vv, aa, bb, o, batch, rows, k, n, c); break;
    default: sddmm_bf16_kernel<VEC8, 32><<<blocks, kSddmmThreads, 0, s>>>(cc, vv, aa, bb, o, batch, rows, k, n, c); break;
  }
}

}  // namespace

extern "C" {

// cols int32 [batch, rows, k], vals fp32 [batch, rows, k], x fp32 [batch, n, c]
// -> out fp32 [batch, rows, c].  vec4 != 0 needs c % 4 == 0 and 16-byte
// aligned x and out; pairs4 != 0 needs k % 4 == 0 and 16-byte aligned cols
// and vals.
int snx_ell_spmm(const void* cols, const void* vals, const void* x, void* out,
                 int batch, int rows, int k, int n, int c, int vec4, int pairs4, void* stream) {
  const long long total = static_cast<long long>(batch) * rows;
  if (total == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;  // 8 warps, one row each
  const unsigned blocks = static_cast<unsigned>((total + threads / 32 - 1) / (threads / 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    ell_spmm_kernel<true><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(out), batch, rows, k, n, c, pairs4);
  } else {
    ell_spmm_kernel<false><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(out), batch, rows, k, n, c, pairs4);
  }
  return static_cast<int>(cudaGetLastError());
}

// block_cols int32 [batch, nb, kb], block_vals fp32 [batch, nb, kb, 128, 128]
// (16-byte aligned), x fp32 [batch, n, c] with n a multiple of 128 -> out
// fp32 [batch, nb*128, c].  vec4 != 0 needs c % 4 == 0 and 16-byte aligned x
// and out.
int snx_bsr_spmm(const void* block_cols, const void* block_vals, const void* x, void* out,
                 int batch, int nb, int kb, int n, int c, int vec4, void* stream) {
  if (batch == 0 || nb == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  // the ring exceeds the 48 KB of static shared memory: allow it once per
  // variant and device
  static bool ready[2][64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !ready[vec4 ? 1 : 0][dev]) {
    e = vec4 ? cudaFuncSetAttribute(bsr_spmm_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBsrSmemBytes)
             : cudaFuncSetAttribute(bsr_spmm_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBsrSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) ready[vec4 ? 1 : 0][dev] = true;
  }
  const dim3 grid((c + kTileN - 1) / kTileN, nb * (kBs / kTileM), batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    bsr_spmm_kernel<true><<<grid, kBsrThreads, kBsrSmemBytes, s>>>(
        static_cast<const int*>(block_cols), static_cast<const float*>(block_vals),
        static_cast<const float*>(x), static_cast<float*>(out), nb, kb, n, c);
  } else {
    bsr_spmm_kernel<false><<<grid, kBsrThreads, kBsrSmemBytes, s>>>(
        static_cast<const int*>(block_cols), static_cast<const float*>(block_vals),
        static_cast<const float*>(x), static_cast<float*>(out), nb, kb, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// cols int32 [batch, rows, k], vals fp32 [batch, rows, k], a fp32
// [batch, rows, c], b fp32 [batch, n, c] -> out fp32 [batch, rows, k].
// vec4 != 0 needs c % 4 == 0 and 16-byte aligned a and b.
int snx_sddmm(const void* cols, const void* vals, const void* a, const void* b, void* out,
              int batch, int rows, int k, int n, int c, int vec4, void* stream) {
  const long long total = static_cast<long long>(batch) * rows;
  if (total == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = static_cast<unsigned>((total + kSddmmThreads / 32 - 1) / (kSddmmThreads / 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    sddmm_kernel<true><<<blocks, kSddmmThreads, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(out), batch, rows, k, n, c);
  } else {
    sddmm_kernel<false><<<blocks, kSddmmThreads, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(out), batch, rows, k, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// cols int32 [batch, rows, k], vals fp32 [batch, rows, k], x bf16 [batch, n, c]
// -> out fp32 [batch, rows, c].  vec8 != 0 needs c % 8 == 0 and 16-byte
// aligned x and out; pairs4 as in snx_ell_spmm.
int snx_ell_spmm_bf16x(const void* cols, const void* vals, const void* x, void* out,
                       int batch, int rows, int k, int n, int c, int vec8, int pairs4, void* stream) {
  const long long total = static_cast<long long>(batch) * rows;
  if (total == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  // a row's lanes (16 bytes of x each), rounded up to a power of two, at most 32
  const int width = vec8 ? c / 8 : c;
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1 << lanes_log2) < width) ++lanes_log2;
  const int threads = 256;  // 8 warps of 32 >> lanes_log2 rows each
  const long long rows_per_block = static_cast<long long>(threads / 32) << (5 - lanes_log2);
  const unsigned blocks = static_cast<unsigned>((total + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec8) {
    ell_spmm_bf16x_kernel<true><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const unsigned short*>(x), static_cast<float*>(out), batch, rows, k, n, c, pairs4, lanes_log2);
  } else {
    ell_spmm_bf16x_kernel<false><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const unsigned short*>(x), static_cast<float*>(out), batch, rows, k, n, c, pairs4, lanes_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

// block_cols int32 [batch, nb, kb], block_vals bf16 [batch, nb, kb, 128, 128]
// (16-byte aligned), live uint8 [batch, nb, kb] or null (every chunk read),
// x fp32 (x_bf16 == 0) or bf16 [batch, n, c] with n a multiple of 128 -> out
// fp32 [batch, nb*128, c].  vec != 0 needs c % 8 == 0 (bf16 x) or c % 4 == 0
// (fp32 x), and 16-byte aligned x and out.
int snx_bsr_spmm_bf16(const void* block_cols, const void* block_vals, const void* live, const void* x, void* out,
                      int batch, int nb, int kb, int n, int c, int x_bf16, int vec, void* stream) {
  if (batch == 0 || nb == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((c + kBfTileN - 1) / kBfTileN, nb * (kBs / kTileM), batch);
  const int smem = kBfStages * (kBfAStageBytes + (x_bf16 ? kBfXStageBytes16 : kBfXStageBytes32)) +
                   kb * static_cast<int>(sizeof(int));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bc = static_cast<const int*>(block_cols);
  const unsigned short* bv = static_cast<const unsigned short*>(block_vals);
  const unsigned char* lv = static_cast<const unsigned char*>(live);
  float* o = static_cast<float*>(out);
  cudaError_t e;
  if (x_bf16) {
    e = vec ? launch_bsr_bf16<true, true>(grid, smem, s, bc, bv, lv, x, o, nb, kb, n, c)
            : launch_bsr_bf16<true, false>(grid, smem, s, bc, bv, lv, x, o, nb, kb, n, c);
  } else {
    e = vec ? launch_bsr_bf16<false, true>(grid, smem, s, bc, bv, lv, x, o, nb, kb, n, c)
            : launch_bsr_bf16<false, false>(grid, smem, s, bc, bv, lv, x, o, nb, kb, n, c);
  }
  return static_cast<int>(e);
}

// cols int32 [batch, rows, k], vals fp32 [batch, rows, k], a bf16
// [batch, rows, c], b bf16 [batch, n, c] -> out bf16 [batch, rows, k].
// vec8 != 0 needs c % 8 == 0 and 16-byte aligned a and b.
int snx_sddmm_bf16(const void* cols, const void* vals, const void* a, const void* b, void* out,
                   int batch, int rows, int k, int n, int c, int vec8, void* stream) {
  const long long total = static_cast<long long>(batch) * rows;
  if (total == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  const int g = sddmm_bf16_lanes(c, vec8 != 0);
  const long long rows_per_block = (kSddmmThreads / 32) * (32 / g);  // 4 warps of 32 / g rows each
  const unsigned blocks = static_cast<unsigned>((total + rows_per_block - 1) / rows_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cc = static_cast<const int*>(cols);
  const float* vv = static_cast<const float*>(vals);
  const unsigned short* aa = static_cast<const unsigned short*>(a);
  const unsigned short* bb = static_cast<const unsigned short*>(b);
  unsigned short* o = static_cast<unsigned short*>(out);
  if (vec8) {
    launch_sddmm_bf16<true>(g, blocks, s, cc, vv, aa, bb, o, batch, rows, k, n, c);
  } else {
    launch_sddmm_bf16<false>(g, blocks, s, cc, vv, aa, bb, o, batch, rows, k, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
