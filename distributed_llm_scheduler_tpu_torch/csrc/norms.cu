// LayerNorm and RMSNorm forward over the last axis for Hopper (sm_90a),
// plain C entries.
//
// Replaces the Pallas TPU kernels `_ln_kernel` (launched by `_ln_pallas`)
// and `_rms_kernel` (launched by `_rms_pallas`),
// distributed_llm_scheduler_tpu/ops/norms.py:32, :43, :58 and :76.  They
// compute the same functions on a (rows, D) view:
//
//   layer norm: mean = sum(x) / D; var = sum((x - mean)^2) / D;
//               y = (x - mean) * rsqrt(var + eps) * g + b
//   rms norm:   y = x * rsqrt(sum(x^2) / D + eps) * g
//
// with every statistic in f32, g and b read in their own dtype and widened,
// and y rounded once to x's dtype.  The variance is two-pass, the mean of
// the centred squares as `_ln_kernel` computes it: E[x^2] - mean^2 cancels
// catastrophically on rows with a large offset.
//
// Layout for the GPU, not carried over block by block: the TPU grid walks
// blocks of up to 256 rows held in VMEM; here one group of threads owns one
// row.  A row of D <= 1024 gets one warp (4 rows per 128-thread block, the
// sums reduced with shuffles alone); a longer row gets the whole block (4
// warps, the warps' partial sums combined through shared memory).  Each
// pass walks the row in 16-byte vectors where the row's start in x and in
// the output share an alignment, with scalar elements before the first
// aligned vector and after the last; so any D, any row stride and any base
// offset work.  Rows are addressed through a row stride, so a row view is
// read in place; the last dim must have unit stride.  The output is a
// contiguous (rows, D) array.
//
// What bounds it on this card: bytes.  Each input element is read once
// from device memory and each output element written once (the later
// passes re-read the row, which a block has just touched, from L1/L2); at
// (1, 512, 4096) bf16 that is 8.4 MB, ~2.5 us at 3.35 TB/s, against a few
// flops per element.  This first version keeps the row in no registers or
// shared memory between passes and re-reads it; keeping a row resident
// and launching enough rows per SM to cover memory latency are the later
// steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // 4 warps
constexpr int SMALL_D = 1024; // rows up to this long get one warp each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// elements of T in one 16-byte vector: 4 floats or 8 bf16
template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

// How a row is walked: `head` scalar elements, then `nvec` aligned vectors
// of Vec<T>::N elements, then scalar elements up to D.  The vector part is
// used only when the x row and the output row are 16-byte aligned at the
// same column.
struct RowSplit {
  int head, nvec, tail0;
};

template <typename T>
__device__ __forceinline__ RowSplit split_row(const T* xr, const T* orow, int D) {
  constexpr int N = Vec<T>::N;
  const uintptr_t ax = reinterpret_cast<uintptr_t>(xr) & 15u;
  const uintptr_t ao = reinterpret_cast<uintptr_t>(orow) & 15u;
  RowSplit s;
  if (ax != ao || (ax % sizeof(T)) != 0) {
    s.head = D;
  } else {
    s.head = min(D, (int)(((16u - ax) & 15u) / sizeof(T)));
  }
  s.nvec = (D - s.head) / N;
  s.tail0 = s.head + s.nvec * N;
  return s;
}

// Sum of f(x_c) over the row, partial per thread: thread `lane` of a group
// of `width` threads takes scalars lane, lane + width, ... and likewise the
// vectors.
template <typename T, typename F>
__device__ __forceinline__ float row_partial(const T* xr, const RowSplit& s,
                                             int D, int lane, int width,
                                             F f) {
  constexpr int N = Vec<T>::N;
  float acc = 0.f;
  for (int c = lane; c < s.head; c += width) acc += f(to_f32(xr[c]));
  const uint4* xv = reinterpret_cast<const uint4*>(xr + s.head);
  for (int i = lane; i < s.nvec; i += width) {
    const uint4 raw = __ldg(xv + i);
    const T* u = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < N; ++e) acc += f(to_f32(u[e]));
  }
  for (int c = s.tail0 + lane; c < D; c += width) acc += f(to_f32(xr[c]));
  return acc;
}

// y_c = f(x_c, c) for every column, stored in the output's dtype
template <typename T, typename F>
__device__ __forceinline__ void row_write(const T* xr, T* orow,
                                          const RowSplit& s, int D, int lane,
                                          int width, F f) {
  constexpr int N = Vec<T>::N;
  for (int c = lane; c < s.head; c += width)
    from_f32(orow + c, f(to_f32(xr[c]), c));
  const uint4* xv = reinterpret_cast<const uint4*>(xr + s.head);
  uint4* ov = reinterpret_cast<uint4*>(orow + s.head);
  for (int i = lane; i < s.nvec; i += width) {
    const uint4 raw = __ldg(xv + i);
    const T* u = reinterpret_cast<const T*>(&raw);
    uint4 packed;
    T* w = reinterpret_cast<T*>(&packed);
    const int c0 = s.head + i * N;
#pragma unroll
    for (int e = 0; e < N; ++e) from_f32(w + e, f(to_f32(u[e]), c0 + e));
    ov[i] = packed;
  }
  for (int c = s.tail0 + lane; c < D; c += width)
    from_f32(orow + c, f(to_f32(xr[c]), c));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of `v` over the group of WARPS warps that owns a row.  Every thread of
// the block calls it the same number of times (no early exits), since the
// multi-warp form synchronises the block.
template <int WARPS>
__device__ __forceinline__ float group_sum(float v, float* red) {
  v = warp_sum(v);
  if (WARPS == 1) return v;
  const int warp = threadIdx.x >> 5;
  const int first = warp - warp % WARPS;  // the group's first warp
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[first + w];
  __syncthreads();  // `red` is reused by the next reduction
  return s;
}

// LN: layer norm (with b) or rms norm.  WARPS: warps per row, 1 or 4.
template <typename T, typename G, int WARPS, bool LN>
__global__ void __launch_bounds__(THREADS)
norm_fwd_kernel(const T* __restrict__ x, const G* __restrict__ g,
                const G* __restrict__ b, T* __restrict__ out, int64_t rows,
                int D, int64_t x_row_stride, float eps) {
  constexpr int ROWS_PER_BLOCK = THREADS / (32 * WARPS);
  constexpr int WIDTH = 32 * WARPS;
  __shared__ float red[THREADS / 32];
  const int lane = threadIdx.x % WIDTH;
  const int grp = threadIdx.x / WIDTH;
  const float fd = (float)D;

  for (int64_t r0 = (int64_t)blockIdx.x * ROWS_PER_BLOCK; r0 < rows;
       r0 += (int64_t)gridDim.x * ROWS_PER_BLOCK) {
    const int64_t row = r0 + grp;
    const bool ok = row < rows;
    // a group past the last row walks an empty row, so that the block
    // still reaches every synchronisation together
    const T* xr = x + (ok ? row : 0) * x_row_stride;
    T* orow = out + (ok ? row : 0) * (int64_t)D;
    const int d = ok ? D : 0;
    const RowSplit s = split_row(xr, orow, d);

    if (LN) {
      const float mean =
          group_sum<WARPS>(row_partial(xr, s, d, lane, WIDTH,
                                       [](float v) { return v; }),
                           red) / fd;
      const float var =
          group_sum<WARPS>(row_partial(xr, s, d, lane, WIDTH,
                                       [mean](float v) {
                                         const float c = v - mean;
                                         return c * c;
                                       }),
                           red) / fd;
      const float rstd = rsqrtf(var + eps);
      row_write(xr, orow, s, d, lane, WIDTH, [=](float v, int c) {
        return (v - mean) * rstd * to_f32(g[c]) + to_f32(b[c]);
      });
    } else {
      const float ms =
          group_sum<WARPS>(row_partial(xr, s, d, lane, WIDTH,
                                       [](float v) { return v * v; }),
                           red) / fd;
      const float rstd = rsqrtf(ms + eps);
      row_write(xr, orow, s, d, lane, WIDTH, [=](float v, int c) {
        return v * rstd * to_f32(g[c]);
      });
    }
  }
}

template <typename T, typename G, bool LN>
cudaError_t launch(const void* x, const void* g, const void* b, void* out,
                   int64_t rows, int D, int64_t x_row_stride, float eps,
                   cudaStream_t stream) {
  if (rows <= 0 || D <= 0) return cudaErrorInvalidValue;
  const bool small = D <= SMALL_D;
  const int64_t per_block = small ? THREADS / 32 : 1;
  int64_t blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) blocks = 0x7fffffffLL;  // the kernel loops
  const dim3 grid((unsigned)blocks), block(THREADS);
  if (small)
    norm_fwd_kernel<T, G, 1, LN><<<grid, block, 0, stream>>>(
        (const T*)x, (const G*)g, (const G*)b, (T*)out, rows, D, x_row_stride,
        eps);
  else
    norm_fwd_kernel<T, G, THREADS / 32, LN><<<grid, block, 0, stream>>>(
        (const T*)x, (const G*)g, (const G*)b, (T*)out, rows, D, x_row_stride,
        eps);
  return cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16
template <bool LN>
int dispatch(const void* x, const void* g, const void* b, void* out,
             int64_t rows, int D, int64_t x_row_stride, int x_dtype,
             int g_dtype, float eps, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && g_dtype == 0)
    return (int)launch<float, float, LN>(x, g, b, out, rows, D, x_row_stride,
                                         eps, s);
  if (x_dtype == 0 && g_dtype == 1)
    return (int)launch<float, __nv_bfloat16, LN>(x, g, b, out, rows, D,
                                                 x_row_stride, eps, s);
  if (x_dtype == 1 && g_dtype == 0)
    return (int)launch<__nv_bfloat16, float, LN>(x, g, b, out, rows, D,
                                                 x_row_stride, eps, s);
  if (x_dtype == 1 && g_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16, LN>(
        x, g, b, out, rows, D, x_row_stride, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x: rows of D elements, row r at x + r * x_row_stride (elements), unit
// stride along a row; g (and b): D contiguous elements of g_dtype; out: a
// contiguous (rows, D) array of x_dtype.  Returns the launch's cudaError_t
// (0 on success); does not synchronise.
extern "C" int dls_layer_norm_fwd(const void* x, const void* g, const void* b,
                                  void* out, long long rows, int D,
                                  long long x_row_stride, int x_dtype,
                                  int g_dtype, float eps, void* stream) {
  return dispatch<true>(x, g, b, out, rows, D, x_row_stride, x_dtype, g_dtype,
                        eps, stream);
}

extern "C" int dls_rms_norm_fwd(const void* x, const void* g, void* out,
                                long long rows, int D, long long x_row_stride,
                                int x_dtype, int g_dtype, float eps,
                                void* stream) {
  return dispatch<false>(x, g, g, out, rows, D, x_row_stride, x_dtype,
                         g_dtype, eps, stream);
}
