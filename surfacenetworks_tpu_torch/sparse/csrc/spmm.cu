// Hand-written Hopper (sm_90a) kernels for the port's sparse operator applies
// and the sampled dense-dense product (SDDMM).
//
// Built by sparse/_build.py with one plain nvcc call into a shared library
// with a C interface, loaded with ctypes (no PyTorch headers).  Every entry
// point launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// All tensors are contiguous; the wrappers in sparse/kernels.py check that.

#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// Scalar-ELL SpMM: out[b, r] = sum_k vals[b, r, k] * x[b, cols[b, r, k]]
//
// One warp per output row.  The warp reads the row's K (col, val) pairs once
// (one pair per lane, handed round with shuffles) and gathers whole rows of
// x: with VEC4 each lane moves 16 bytes, so one gathered row of 128 fp32
// channels is one fully coalesced 512-byte read.  Padding slots (val == 0)
// are skipped, which gives the same sum as multiplying them in for finite x.
// A column outside [0, n) is skipped too, rather than read out of bounds: a
// guard only.  The operators' columns are range-checked on the host when
// they are copied to the card, so the port's path never relies on it.
// ---------------------------------------------------------------------------
template <bool VEC4>
__global__ void ell_spmm_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                                const float* __restrict__ x, float* __restrict__ out,
                                int batch, int rows, int k, int n, int c) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(batch) * rows) return;  // whole warp leaves together
  const long long b = row / rows;
  const int* row_cols = cols + row * k;
  const float* row_vals = vals + row * k;
  const float* xb = x + b * n * static_cast<long long>(c);
  float* orow = out + row * c;

  const int width = VEC4 ? c / 4 : c;  // channel axis in units of float4 or float
  for (int j0 = 0; j0 < width; j0 += 32) {
    const int j = j0 + lane;
    const bool live = j < width;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < k; s0 += 32) {
      int my_col = 0;
      float my_val = 0.f;
      if (s0 + lane < k) {
        my_col = row_cols[s0 + lane];
        my_val = row_vals[s0 + lane];
      }
      const int ns = min(32, k - s0);
      for (int s = 0; s < ns; ++s) {
        const float v = __shfl_sync(0xffffffffu, my_val, s);
        const int col = __shfl_sync(0xffffffffu, my_col, s);
        if (v == 0.f || !live || col < 0 || col >= n) continue;  // warp-uniform
        if (VEC4) {
          const float4 xv = reinterpret_cast<const float4*>(xb + static_cast<long long>(col) * c)[j];
          acc.x = fmaf(v, xv.x, acc.x);
          acc.y = fmaf(v, xv.y, acc.y);
          acc.z = fmaf(v, xv.z, acc.z);
          acc.w = fmaf(v, xv.w, acc.w);
        } else {
          acc.x = fmaf(v, xb[static_cast<long long>(col) * c + j], acc.x);
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
// Block-ELL SpMM over 128x128 blocks:
//   out[b, i*128 + m, ch] = sum_s sum_j vals[b, i, s, m, j] * x[b, cols[b, i, s]*128 + j, ch]
//
// One CTA per (channel tile of 64, block-row i, batch b); it loops over the
// block-row's KB slots itself, reading cols[b, i, s].  Each slot's 128x128
// block and the matching 128 x 64 slice of x pass through shared memory in
// depth chunks of 32; every thread keeps an 8 x 4 tile of the 128 x 64 output
// in registers and accumulates with fp32 FMA.  The ragged channel edge is
// masked on load and store.  A block-column outside [0, n/128) is skipped, as
// a guard against reading out of bounds (the host checks the range).
// ---------------------------------------------------------------------------
constexpr int kBs = 128;      // block size (rows and columns of a block)
constexpr int kTileC = 64;    // channels per CTA
constexpr int kDepth = 32;    // depth chunk staged in shared memory
constexpr int kThreads = 256; // 16 x 16 threads, 8 rows x 4 channels each

__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const int* __restrict__ block_cols, const float* __restrict__ block_vals,
                const float* __restrict__ x, float* __restrict__ out,
                int nb, int kb, int n, int c) {
  // a_s is stored transposed ([depth][row]) so the compute loop reads rows
  // contiguously; the +4 pad keeps float4 alignment and spreads banks.
  __shared__ __align__(16) float a_s[kDepth][kBs + 4];
  __shared__ __align__(16) float x_s[kDepth][kTileC];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // channel group: 4 channels
  const int ty = tid / 16;  // row group: 8 rows
  const int c0 = blockIdx.x * kTileC;
  const long long i = blockIdx.y;
  const long long b = blockIdx.z;

  const int* cols_i = block_cols + (b * nb + i) * kb;
  const float* vals_i = block_vals + (b * nb + i) * kb * static_cast<long long>(kBs * kBs);
  const float* xb = x + b * n * static_cast<long long>(c);

  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  for (int s = 0; s < kb; ++s) {
    const long long col = cols_i[s];
    if (col < 0 || col >= n / kBs) continue;  // out of range: skipped, same for the whole CTA
    const float* a = vals_i + s * static_cast<long long>(kBs * kBs);  // row-major [m][j]
    const float* xs = xb + col * kBs * c;                               // rows col*128 ...
    for (int d0 = 0; d0 < kBs; d0 += kDepth) {
      // block chunk a[m][d0 .. d0+32): 128 rows x 8 float4, 4 float4 per thread
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int idx = tid + t * kThreads;
        const int m = idx / (kDepth / 4);
        const int dq = idx % (kDepth / 4);
        const float4 v = *reinterpret_cast<const float4*>(a + m * kBs + d0 + dq * 4);
        a_s[dq * 4 + 0][m] = v.x;
        a_s[dq * 4 + 1][m] = v.y;
        a_s[dq * 4 + 2][m] = v.z;
        a_s[dq * 4 + 3][m] = v.w;
      }
      // x chunk rows d0 .. d0+32, channels c0 .. c0+64: 8 values per thread
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int idx = tid + t * kThreads;
        const int dd = idx / kTileC;
        const int cc = idx % kTileC;
        const int ch = c0 + cc;
        x_s[dd][cc] = ch < c ? xs[static_cast<long long>(d0 + dd) * c + ch] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < kDepth; ++dd) {
        const float4 a0 = *reinterpret_cast<const float4*>(&a_s[dd][ty * 8]);
        const float4 a1 = *reinterpret_cast<const float4*>(&a_s[dd][ty * 8 + 4]);
        const float4 xv = *reinterpret_cast<const float4*>(&x_s[dd][tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
      }
      __syncthreads();
    }
  }

  float* ob = out + (b * nb * kBs + i * kBs) * static_cast<long long>(c);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const long long m = ty * 8 + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ch = c0 + tx * 4 + q;
      if (ch < c) ob[m * c + ch] = acc[r][q];
    }
  }
}

// ---------------------------------------------------------------------------
// SDDMM at an ELL pattern:
//   out[b, r, k] = <a[b, r], b[b, cols[b, r, k]]> where vals[b, r, k] != 0, else 0
//
// One warp per row r.  Each lane keeps its float4 of a[r] in registers (the
// first 128 channels; wider rows read the rest again from L1).  The row's K
// (col, val) pairs are handed round with shuffles, as in ell_spmm_kernel; for
// each live slot the warp reads b[col] with 16-byte loads, forms the lanes'
// partial products and reduces them with an xor butterfly, after which every
// lane holds the dot product.  Lane s keeps slot s's result, so the row's K
// outputs leave in one coalesced store.  Padding slots (val == 0) give 0, and
// a column outside [0, n) gives 0 rather than a read out of bounds (a guard
// only: the host range-checks the pattern).
// ---------------------------------------------------------------------------
template <bool VEC4>
__device__ __forceinline__ float4 load4(const float* p, int j) {
  if (VEC4) return reinterpret_cast<const float4*>(p)[j];
  return make_float4(p[j], 0.f, 0.f, 0.f);
}

__device__ __forceinline__ float dot4(float4 u, float4 v) {
  return fmaf(u.x, v.x, fmaf(u.y, v.y, fmaf(u.z, v.z, u.w * v.w)));
}

template <bool VEC4>
__global__ void sddmm_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                             const float* __restrict__ a, const float* __restrict__ b,
                             float* __restrict__ out, int batch, int rows, int k, int n, int c) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(batch) * rows) return;  // whole warp leaves together
  const long long bi = row / rows;
  const int* row_cols = cols + row * k;
  const float* row_vals = vals + row * k;
  const float* arow = a + row * c;
  const float* bb = b + bi * n * static_cast<long long>(c);
  float* orow = out + row * k;

  const int width = VEC4 ? c / 4 : c;  // channel axis in units of float4 or float
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 a0 = lane < width ? load4<VEC4>(arow, lane) : zero;
  for (int s0 = 0; s0 < k; s0 += 32) {
    int my_col = 0;
    float my_val = 0.f;
    if (s0 + lane < k) {
      my_col = row_cols[s0 + lane];
      my_val = row_vals[s0 + lane];
    }
    float my_out = 0.f;
    const int ns = min(32, k - s0);
    for (int s = 0; s < ns; ++s) {
      const float v = __shfl_sync(0xffffffffu, my_val, s);
      const int col = __shfl_sync(0xffffffffu, my_col, s);
      if (v == 0.f || col < 0 || col >= n) continue;  // warp-uniform
      const float* brow = bb + static_cast<long long>(col) * c;
      float p = lane < width ? dot4(a0, load4<VEC4>(brow, lane)) : 0.f;
      for (int j = lane + 32; j < width; j += 32) p += dot4(load4<VEC4>(arow, j), load4<VEC4>(brow, j));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == s) my_out = p;
    }
    if (lane < ns) orow[s0 + lane] = my_out;
  }
}

}  // namespace

extern "C" {

// cols int32 [batch, rows, k], vals fp32 [batch, rows, k], x fp32 [batch, n, c]
// -> out fp32 [batch, rows, c].  vec4 != 0 needs c % 4 == 0 and 16-byte
// aligned x and out.
int snx_ell_spmm(const void* cols, const void* vals, const void* x, void* out,
                 int batch, int rows, int k, int n, int c, int vec4, void* stream) {
  const long long total = static_cast<long long>(batch) * rows;
  if (total == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;  // 8 warps, one row each
  const unsigned blocks = static_cast<unsigned>((total + threads / 32 - 1) / (threads / 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    ell_spmm_kernel<true><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(out), batch, rows, k, n, c);
  } else {
    ell_spmm_kernel<false><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals),
        static_cast<const float*>(x), static_cast<float*>(out), batch, rows, k, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// block_cols int32 [batch, nb, kb], block_vals fp32 [batch, nb, kb, 128, 128],
// x fp32 [batch, n, c] with n a multiple of 128 -> out fp32 [batch, nb*128, c].
int snx_bsr_spmm(const void* block_cols, const void* block_vals, const void* x, void* out,
                 int batch, int nb, int kb, int n, int c, void* stream) {
  if (batch == 0 || nb == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((c + kTileC - 1) / kTileC, nb, batch);
  bsr_spmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(block_cols), static_cast<const float*>(block_vals),
      static_cast<const float*>(x), static_cast<float*>(out), nb, kb, n, c);
  return static_cast<int>(cudaGetLastError());
}

// cols int32 [batch, rows, k], vals fp32 [batch, rows, k], a fp32
// [batch, rows, c], b fp32 [batch, n, c] -> out fp32 [batch, rows, k].
// vec4 != 0 needs c % 4 == 0 and 16-byte aligned a and b.
int snx_sddmm(const void* cols, const void* vals, const void* a, const void* b, void* out,
              int batch, int rows, int k, int n, int c, int vec4, void* stream) {
  const long long total = static_cast<long long>(batch) * rows;
  if (total == 0 || k == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;  // 8 warps, one row each
  const unsigned blocks = static_cast<unsigned>((total + threads / 32 - 1) / (threads / 32));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    sddmm_kernel<true><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(out), batch, rows, k, n, c);
  } else {
    sddmm_kernel<false><<<blocks, threads, 0, s>>>(
        static_cast<const int*>(cols), static_cast<const float*>(vals), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<float*>(out), batch, rows, k, n, c);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
