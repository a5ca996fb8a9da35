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
// What bounds it on this card: bytes, and below a few MB the latency of
// getting them.  Each input element is read once from device memory and
// each output element written once; at (1, 512, 4096) bf16 that is 8.4 MB,
// ~2.5 us at 3.35 TB/s, against a few flops per element.  At GPT-2's
// (1, 512, 768) it is 1.6 MB, 0.47 us, less than one round trip to device
// memory and back; there the time is the launch, one memory latency for the
// loads and one for the stores, and every extra dependent round of loads
// adds a latency.
//
// Two kernels, chosen per call on the host (`ops/norms.py` `norm_plan`,
// from shape, row stride, dtype and the pointers' alignment; never after a
// failed launch):
//
// * `norm_reg_kernel`, the register path.  It replaced, for every row whose
//   x and output starts are 16-byte aligned and whose width is whole
//   16-byte vectors, a first kernel that walked each row two or three times
//   (LayerNorm: mean, centred variance, write) and read g and b one scalar
//   at a time.  A group of TPR threads (one warp, or a 4-warp block) owns a
//   row; each thread holds VPT 16-byte vectors of it in registers, vector
//   j * TPR + lane, so neighbouring lanes read neighbouring 16 bytes and a
//   thread's slots past the row's end are masked (not loaded, summed as
//   nothing).  All VPT loads of a row (`ld.global.nc`, 16 bytes each) are
//   issued before the first use; both statistics and the write come from
//   the registers, so the two-pass variance costs no memory traffic.  g and
//   b are read as 16-byte vectors into registers once per thread, before
//   the row loop, and kept across the rows a thread group walks: the grid
//   is capped at the blocks the card holds at once (occupancy x SMs), so
//   a long input is walked by a persistent grid-stride loop and a short one
//   puts every row's loads in flight together.  GPT-2's (512, 768) bf16:
//   one warp per row, 3 live vectors of 4 per lane, 512 warps on ~4 per SM;
//   Llama's (512, 4096) bf16: a 128-thread block per row, 4 vectors per
//   thread (8 KB a row, ~4 rows and ~32 KB in flight on each SM; 128
//   threads rather than 256 keep the cross-warp sum to 4 partials and give
//   each thread 4 independent loads).
// * `norm_fwd_kernel`, the streaming path, the first kernel kept for what
//   the register path does not take: a row whose x start and output start
//   differ in 16-byte alignment (or whose width is not whole vectors), a
//   row longer than the largest register instance (8192 bf16 or 4096 f32
//   elements), and unaligned weights.  A row of D <= 1024 gets one warp (4
//   rows per 128-thread block, the sums reduced with shuffles alone); a
//   longer row gets the whole block (4 warps, the warps' partial sums
//   combined through shared memory).  Each pass walks the row in 16-byte
//   vectors where the row's start in x and in the output share an
//   alignment, with scalar elements before the first aligned vector and
//   after the last; so any D, any row stride and any base offset work.  It
//   re-reads the row for each pass (from L1/L2) and g and b per element.
//
// Rows are addressed through a row stride, so a row view is read in place;
// the last dim must have unit stride.  The output is a contiguous (rows, D)
// array.  No TMA, shared-memory staging or tensor cores: a norm does a few
// operations a byte and a row fits in registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// -- the streaming path ---------------------------------------------------

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

// -- the register path ----------------------------------------------------

// word i (0-3) of a 16-byte vector; i is a constant once unrolled
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Values of type E packed in 32-bit words (4 floats or 8 bf16 to a 16-byte
// vector): get(w, k) widens element k of the words w(0), w(1), ... to f32;
// put(y) rounds y(0), y(1), ..., one 16-byte vector's worth of f32 values,
// to E and packs them.  k is a constant once unrolled, and no array is
// formed, so nothing leaves the registers.
template <typename E>
struct Packed;
template <>
struct Packed<float> {
  template <typename W>
  static __device__ __forceinline__ float get(W w, int k) {
    return __uint_as_float(w(k));
  }
  template <typename Y>
  static __device__ __forceinline__ uint4 put(Y y) {
    return make_uint4(__float_as_uint(y(0)), __float_as_uint(y(1)),
                      __float_as_uint(y(2)), __float_as_uint(y(3)));
  }
};
template <>
struct Packed<__nv_bfloat16> {
  template <typename W>
  static __device__ __forceinline__ float get(W w, int k) {
    const uint32_t v = w(k >> 1);
    return __uint_as_float((k & 1) ? (v & 0xffff0000u) : (v << 16));
  }
  static __device__ __forceinline__ uint32_t pair(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
  }
  template <typename Y>
  static __device__ __forceinline__ uint4 put(Y y) {
    return make_uint4(pair(y(0), y(1)), pair(y(2), y(3)), pair(y(4), y(5)),
                      pair(y(6), y(7)));
  }
};

__device__ __forceinline__ uint4 ld_nc(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));  // ld.global.nc.v4
}

// The N elements of g (or b) that pair with one x vector, W = N * sizeof(G)
// / 4 words (2, 4 or 8), read as one 8-byte or one or two 16-byte vectors.
template <typename G, int N>
__device__ __forceinline__ void load_weights(uint32_t* w, const G* p) {
  constexpr int W = N * (int)sizeof(G) / 4;
  if constexpr (W == 2) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = t.x;
    w[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 t = ld_nc(p + i * 16 / sizeof(G));
      w[4 * i] = t.x;
      w[4 * i + 1] = t.y;
      w[4 * i + 2] = t.z;
      w[4 * i + 3] = t.w;
    }
  }
}

// Sum of v over the TPR threads that own a row: shuffles within a warp; for
// a block-wide row (WARPS > 1, one row per block) the warps' sums meet in
// `red`, one of two buffers taken in turn, so a reduction needs a single
// barrier: the next reduction's barrier orders this one's reads before the
// buffer is written again.
template <int WARPS>
__device__ __forceinline__ float row_total(float v, float* red) {
  v = warp_sum(v);
  if constexpr (WARPS == 1) {
    return v;
  } else {
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w];
    return s;
  }
}

// LN: layer norm (with b) or rms norm.  TPR threads own a row (32: a warp,
// 4 rows per block; 128: the block); each holds VPT 16-byte vectors of it,
// vector j * TPR + lane in its slot j.  The caller guarantees D % N == 0,
// D <= TPR * VPT * N, and 16-byte aligned x rows, output, g and b.  The
// launch bound asks for one resident block only: left to aim at six,
// ptxas caps one instance (f32 x, bf16 g, RMS, 128 x 8) at 80 registers
// and spills 16 bytes.  The rows in flight come from the grid: at the
// main paths' shapes every row's block is resident at once.
template <typename T, typename G, bool LN, int TPR, int VPT>
__global__ void __launch_bounds__(THREADS, 1)
norm_reg_kernel(const T* __restrict__ x, const G* __restrict__ g,
                const G* __restrict__ b, T* __restrict__ out, int64_t rows,
                int D, int64_t x_row_stride, float eps) {
  constexpr int N = Vec<T>::N;
  constexpr int GW = N * (int)sizeof(G) / 4;  // words of g per x vector
  constexpr int RPB = THREADS / TPR;          // rows per block
  __shared__ float red[2][THREADS / 32];
  const int lane = threadIdx.x % TPR;
  const int nvec = D / N;
  const float fd = (float)D;

  // g and b: read once, kept across every row this group walks
  uint32_t gw[VPT][GW], bw[VPT][GW];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int vi = j * TPR + lane;
#pragma unroll
    for (int i = 0; i < GW; ++i) gw[j][i] = bw[j][i] = 0u;
    if (vi < nvec) {
      load_weights<G, N>(gw[j], g + vi * N);
      if (LN) load_weights<G, N>(bw[j], b + vi * N);
    }
  }

  int buf = 0;
  for (int64_t row = (int64_t)blockIdx.x * RPB + threadIdx.x / TPR; row < rows;
       row += (int64_t)gridDim.x * RPB) {
    // every load of the row in flight before the first use
    const T* xr = x + row * x_row_stride;
    uint4 xq[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int vi = j * TPR + lane;
      xq[j] = vi < nvec ? ld_nc(xr + vi * N) : make_uint4(0u, 0u, 0u, 0u);
    }
    // masked slots hold zeros, which add nothing to sum(x) or sum(x^2)
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const auto xw = [&](int i) { return word(xq[j], i); };
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float v = Packed<T>::get(xw, k);
        s += LN ? v : v * v;
      }
    }
    float mean = 0.f, rstd;
    if (LN) {
      mean = row_total<TPR / 32>(s, red[buf]) / fd;
      buf ^= 1;
      float c2 = 0.f;  // the centred squares, from the registers
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (j * TPR + lane >= nvec) continue;
        const auto xw = [&](int i) { return word(xq[j], i); };
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float c = Packed<T>::get(xw, k) - mean;
          c2 += c * c;
        }
      }
      rstd = rsqrtf(row_total<TPR / 32>(c2, red[buf]) / fd + eps);
    } else {
      rstd = rsqrtf(row_total<TPR / 32>(s, red[buf]) / fd + eps);
    }
    buf ^= 1;

    T* orow = out + row * (int64_t)D;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int vi = j * TPR + lane;
      if (vi >= nvec) continue;
      const auto xw = [&](int i) { return word(xq[j], i); };
      const auto gj = [&](int i) { return gw[j][i]; };
      const auto bj = [&](int i) { return bw[j][i]; };
      const auto y = [&](int k) {
        const float v = Packed<T>::get(xw, k);
        const float gv = Packed<G>::get(gj, k);
        return LN ? (v - mean) * rstd * gv + Packed<G>::get(bj, k)
                  : v * rstd * gv;
      };
      *reinterpret_cast<uint4*>(orow + vi * N) = Packed<T>::put(y);
    }
  }
}

template <typename T, typename G, bool LN, int TPR, int VPT>
cudaError_t launch_reg_as(const void* x, const void* g, const void* b,
                          void* out, int64_t rows, int D, int64_t x_row_stride,
                          float eps, cudaStream_t stream) {
  const auto kernel = norm_reg_kernel<T, G, LN, TPR, VPT>;
  // the blocks of this instance the card holds at once, found on first use:
  // more rows than that are walked by the grid-stride loop
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
    if (e != cudaSuccess) return e;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  constexpr int RPB = THREADS / TPR;
  const int64_t need = (rows + RPB - 1) / RPB;
  const unsigned blocks = (unsigned)(need < resident ? need : resident);
  kernel<<<blocks, THREADS, 0, stream>>>((const T*)x, (const G*)g,
                                         (const G*)b, (T*)out, rows, D,
                                         x_row_stride, eps);
  return cudaGetLastError();
}

// The register instances, (threads per row, vectors per thread): a warp
// for rows of up to 4 vectors a lane (1,024 bf16 or 512 f32 elements), a
// 128-thread block above that, up to 8 vectors a thread (8,192 bf16 or
// 4,096 f32).  `ops/norms.py` REGISTER_SHAPES lists the same pairs.
template <typename T, typename G, bool LN>
cudaError_t launch_reg(const void* x, const void* g, const void* b, void* out,
                       int64_t rows, int D, int64_t x_row_stride, float eps,
                       int tpr, int vpt, cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) != 0;
  };
  if (rows <= 0 || D <= 0 || D % N != 0 || D > tpr * vpt * N ||
      (rows > 1 && x_row_stride % N != 0) || misaligned(x) ||
      misaligned(out) || misaligned(g) || (LN && misaligned(b)))
    return cudaErrorInvalidValue;
#define DLS_NORM_REG(TPR_, VPT_)                                          \
  if (tpr == TPR_ && vpt == VPT_)                                         \
    return launch_reg_as<T, G, LN, TPR_, VPT_>(x, g, b, out, rows, D,     \
                                               x_row_stride, eps, stream)
  DLS_NORM_REG(32, 1);
  DLS_NORM_REG(32, 2);
  DLS_NORM_REG(32, 4);
  DLS_NORM_REG(128, 2);
  DLS_NORM_REG(128, 4);
  DLS_NORM_REG(128, 8);
#undef DLS_NORM_REG
  return cudaErrorInvalidValue;
}

// dtype codes: 0 = float32, 1 = bfloat16.  Calls f with null pointers of x's
// and g's element types, from which it takes T and G.
template <typename F>
int by_dtype(int x_dtype, int g_dtype, F f) {
  float* f32 = nullptr;
  __nv_bfloat16* bf16 = nullptr;
  if (x_dtype == 0 && g_dtype == 0) return (int)f(f32, f32);
  if (x_dtype == 0 && g_dtype == 1) return (int)f(f32, bf16);
  if (x_dtype == 1 && g_dtype == 0) return (int)f(bf16, f32);
  if (x_dtype == 1 && g_dtype == 1) return (int)f(bf16, bf16);
  return (int)cudaErrorInvalidValue;
}

#define DLS_TYPES(xt, gt)                                \
  using T = std::remove_pointer_t<decltype(xt)>;         \
  using G = std::remove_pointer_t<decltype(gt)>

__global__ void empty_kernel() {}

}  // namespace

// x: rows of D elements, row r at x + r * x_row_stride (elements), unit
// stride along a row; g (and b): D contiguous elements of g_dtype; out: a
// contiguous (rows, D) array of x_dtype.  Each returns the launch's
// cudaError_t (0 on success) and does not synchronise.

// The streaming kernel: any alignment, any D.
extern "C" int dls_layer_norm_fwd(const void* x, const void* g, const void* b,
                                  void* out, long long rows, int D,
                                  long long x_row_stride, int x_dtype,
                                  int g_dtype, float eps, void* stream) {
  return by_dtype(x_dtype, g_dtype, [&](auto* xt, auto* gt) {
    DLS_TYPES(xt, gt);
    return launch<T, G, true>(x, g, b, out, rows, D, x_row_stride, eps,
                              (cudaStream_t)stream);
  });
}

extern "C" int dls_rms_norm_fwd(const void* x, const void* g, void* out,
                                long long rows, int D, long long x_row_stride,
                                int x_dtype, int g_dtype, float eps,
                                void* stream) {
  return by_dtype(x_dtype, g_dtype, [&](auto* xt, auto* gt) {
    DLS_TYPES(xt, gt);
    return launch<T, G, false>(x, g, g, out, rows, D, x_row_stride, eps,
                               (cudaStream_t)stream);
  });
}

// The register kernel, instance (tpr threads per row, vpt vectors per
// thread); cudaErrorInvalidValue when the call breaks its preconditions
// (see launch_reg) or names no instance.
extern "C" int dls_layer_norm_reg_fwd(const void* x, const void* g,
                                      const void* b, void* out,
                                      long long rows, int D,
                                      long long x_row_stride, int x_dtype,
                                      int g_dtype, float eps, int tpr,
                                      int vpt, void* stream) {
  return by_dtype(x_dtype, g_dtype, [&](auto* xt, auto* gt) {
    DLS_TYPES(xt, gt);
    return launch_reg<T, G, true>(x, g, b, out, rows, D, x_row_stride, eps,
                                  tpr, vpt, (cudaStream_t)stream);
  });
}

extern "C" int dls_rms_norm_reg_fwd(const void* x, const void* g, void* out,
                                    long long rows, int D,
                                    long long x_row_stride, int x_dtype,
                                    int g_dtype, float eps, int tpr, int vpt,
                                    void* stream) {
  return by_dtype(x_dtype, g_dtype, [&](auto* xt, auto* gt) {
    DLS_TYPES(xt, gt);
    return launch_reg<T, G, false>(x, g, g, out, rows, D, x_row_stride, eps,
                                   tpr, vpt, (cudaStream_t)stream);
  });
}

// A kernel with no work on `blocks` blocks of the norm kernels' THREADS:
// its time in a CUDA graph is the per-launch floor beside a norm kernel's.
extern "C" int dls_norm_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
