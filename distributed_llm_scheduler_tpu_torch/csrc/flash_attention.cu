// Causal / full flash-attention forward for Hopper (sm_90a), plain C entry.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by `_flash_mha`
// (distributed_llm_scheduler_tpu/ops/attention.py:59 and :152).  It computes
// the same function, softmax(q k^T * scale [causal mask]) v over
// (B, H, T, hd), with the online softmax's running max, denominator and
// accumulator in f32 and the output in the input dtype, but it is laid
// out for the GPU, not carried over block by block:
//
//   * one thread block per (b*h, 64-row query tile), 256 threads: four
//     threads per query row, each owning a quarter of the head dims;
//   * K/V tiles of BN rows are staged through shared memory (converted to
//     f32 once per tile) and walked by a loop inside the block, which takes
//     the place of the TPU grid's sequential K/V walk; under `causal` the
//     loop stops at the diagonal tile;
//   * the ragged tail is masked in the kernel, so any T >= 1 works (the TPU
//     path needs T divisible by a power-of-two block);
//   * q, k, v and o are addressed through (b, h, t) strides with a unit
//     stride on the head dim, so views of a fused qkv projection are read in
//     place and no transposing copy is needed.
//
// What bounds it on this card: at the GPT-2 shapes of the main path
// ((1, 12, 512, 64) bf16) the least time is set by memory traffic (q, k, v
// and o, 3.15 MB, ~0.94 us at 3.35 TB/s) against ~0.41 us of tensor-core
// work.  This first version does its products with f32 FMA on the CUDA
// cores, so it is bound by those instructions, far above either bound.
// The design keeps scores out of device memory (the O(T^2) traffic the
// flash formulation exists to avoid); moving the two products onto
// `mma.sync`/`wgmma` with TMA-fed tiles is the later step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per block
constexpr int THREADS = 256;  // 4 threads per query row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// HD: head dim; BN: key rows per shared-memory tile.
template <typename T, int HD, int BN>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int H, int Tlen, int n_qtiles,
                 int64_t qsb, int64_t qsh, int64_t qst,
                 int64_t ksb, int64_t ksh, int64_t kst,
                 int64_t vsb, int64_t vsh, int64_t vst,
                 int64_t osb, int64_t osh, int64_t ost,
                 int causal, float scale_log2) {
  // each thread owns HD/4 dims of its row, as HD/16 float4 groups
  // interleaved across the row's four threads (conflict-free smem reads)
  constexpr int G = HD / 16;
  __shared__ __align__(16) float Ks[BN * HD];
  __shared__ __align__(16) float Vs[BN * HD];

  const int bh = blockIdx.x / n_qtiles;
  const int qt = blockIdx.x % n_qtiles;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int r = tid >> 2;     // row within the tile
  const int part = tid & 3;   // which quarter of the head dims
  const int q0 = qt * BM;
  const int row = q0 + r;     // absolute query position
  const bool row_ok = row < Tlen;

  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + h * ksh;
  const T* vb = v + b * vsb + h * vsh;

  // q row slice, pre-scaled by scale*log2(e) so the softmax uses exp2
  float qr[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (g * 4 + part) * 4 + e;
      qr[g][e] = row_ok ? to_f32(qb[row * qst + d]) * scale_log2 : 0.f;
    }
  }

  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  float m = -INFINITY;  // running max (log2 domain)
  float l = 0.f;        // running denominator

  // keys this tile needs: all of them, or up to the tile's last row
  const int kv_end = causal ? min(q0 + BM, Tlen) : Tlen;
  const int n_ktiles = (kv_end + BN - 1) / BN;

  for (int kt = 0; kt < n_ktiles; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BN * HD; i += THREADS) {
      const int kr = i / HD, d = i % HD;
      const int t = k0 + kr;
      const bool ok = t < Tlen;
      Ks[i] = ok ? to_f32(kb[t * kst + d]) : 0.f;
      Vs[i] = ok ? to_f32(vb[t * vst + d]) : 0.f;
    }
    __syncthreads();

    float s[BN];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float4* kr4 = reinterpret_cast<const float4*>(Ks + j * HD);
      float dot = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 kk = kr4[g * 4 + part];
        dot = fmaf(qr[g][0], kk.x, dot);
        dot = fmaf(qr[g][1], kk.y, dot);
        dot = fmaf(qr[g][2], kk.z, dot);
        dot = fmaf(qr[g][3], kk.w, dot);
      }
      // the row's four threads are adjacent lanes: reduce among them
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int col = k0 + j;
      const bool keep = col < Tlen && (!causal || col <= row);
      s[j] = keep ? dot : -INFINITY;
      tile_max = fmaxf(tile_max, s[j]);
    }

    // key 0 is visible to every row, so m is finite after the first tile
    const float m_new = fmaxf(m, tile_max);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
#pragma unroll
    for (int j = 0; j < BN; ++j) {
      const float p = exp2f(s[j] - m_new);
      l += p;
      const float4* vr4 = reinterpret_cast<const float4*>(Vs + j * HD);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 vv = vr4[g * 4 + part];
        acc[g][0] = fmaf(p, vv.x, acc[g][0]);
        acc[g][1] = fmaf(p, vv.y, acc[g][1]);
        acc[g][2] = fmaf(p, vv.z, acc[g][2]);
        acc[g][3] = fmaf(p, vv.w, acc[g][3]);
      }
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.f / l;
    T* ob = o + b * osb + h * osh + row * ost;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        store(ob + (g * 4 + part) * 4 + e, acc[g][e] * inv);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Tlen, int hd, const int64_t* st,
                   int causal, float sm_scale, cudaStream_t stream) {
  const int n_qtiles = (Tlen + BM - 1) / BM;
  const long long blocks = (long long)B * H * n_qtiles;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks), block(THREADS);
  const float sl = sm_scale * LOG2E;
#define DLS_FLASH_ARGS                                                     \
  (const T*)q, (const T*)k, (const T*)v, (T*)o, H, Tlen, n_qtiles, st[0], \
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],       \
      st[10], st[11], causal, sl
  switch (hd) {
    case 32:
      flash_fwd_kernel<T, 32, 64><<<grid, block, 0, stream>>>(DLS_FLASH_ARGS);
      break;
    case 64:
      flash_fwd_kernel<T, 64, 64><<<grid, block, 0, stream>>>(DLS_FLASH_ARGS);
      break;
    case 128:
      flash_fwd_kernel<T, 128, 32><<<grid, block, 0, stream>>>(DLS_FLASH_ARGS);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef DLS_FLASH_ARGS
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  strides: 12 element strides, (b, h, t)
// for q, k, v and o in that order; the head dim has unit stride.  Returns
// the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int dls_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int Tlen, int hd, const int64_t* strides,
                                       int dtype, int causal, float sm_scale,
                                       void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k, v, o, B, H, Tlen, hd, strides, causal,
                              sm_scale, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, o, B, H, Tlen, hd, strides,
                                      causal, sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
