// Ragged paged attention for Hopper (sm_90a), plain C entry points.
//
// Replaces the two Pallas TPU kernels of distributed_llm_scheduler_tpu/
// ops/attention.py:
//   * `_paged_kernel` (:333, launched by `_paged_flash` :411): one new
//     token per slot, with this step's K/V row inserted at position
//     min(L, cap-1) before the scores; slot s attends positions <= L;
//   * `_paged_ragged_kernel` (:474, launched by `_paged_flash_ragged`
//     :547): Tn query rows per slot, row t attending positions
//     <= L + clip(t, 0, max(q_lens[s]-1, 0)); no insert.
// Both compute softmax(q k^T * scale) v over a slot's pages, reached
// through the page table, with the online softmax's running max,
// denominator and accumulator in f32 and the output in q's dtype.  GQA
// folds the Hq query heads onto Hkv KV heads: query row c of KV head h is
// head h*G + c/Tn at token c%Tn, the JAX package's (Hkv, G*Tn) order.
//
// Layout for the GPU rather than the TPU's (slot, page) grid:
//   * one thread block per (slot, KV head, tile of up to RB query rows),
//     128 threads; the block walks the slot's positions in chunks of 128,
//     one position per thread, reading the page id of each position from
//     the page table in device memory (so any page size works);
//   * phase 1: each thread loads its key's K row (16-byte vectors) and
//     scores it against the block's query rows, which sit pre-scaled in
//     shared memory; positions a row may not see get -inf, so nothing of
//     a masked row (a poisoned trash page included) enters a sum;
//   * phase 2: one warp per query row folds the chunk into the running
//     max and denominator (exp2 on log2-scaled scores);
//   * phase 3: each thread owns output elements (row, dim) and adds
//     p * V over the chunk, V rows read straight from device memory,
//     neighbouring threads on neighbouring dims;
//   * the walk stops after the last position any row of the slot can
//     see, so pages wholly past the length are never read.
//
// What bounds it on this card: decode at the GPT-2 serving shape (8
// slots, 12 heads, hd 64, bf16, ~256 live positions per slot) moves the
// live K/V rows once, ~6 MB per call, ~2 us at 3.35 TB/s; the products
// are far below the tensor cores' rate.  This first version does them
// with f32 FMA on the CUDA cores and keeps one block per (slot, head):
// 96 blocks on 132 SMs at that shape, each walking its whole sequence.
// Splitting a slot's positions across blocks (flash-decoding) and
// staging K/V through shared memory with cp.async are the later steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads per block = positions per chunk
constexpr int NW = NT / 32;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 8 consecutive elements at a 16-byte aligned address, as f32
__device__ __forceinline__ void load8(const float* p, float (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

template <typename T>
struct Args {
  const T* q;           // (S, Hq, Tn, hd), strides qs_* with unit hd stride
  const T* k_pool;      // (P, ps, Hkv, hd) contiguous
  const T* v_pool;
  const int* pt;        // (S, ppseq) int32
  const int* lengths;   // (S,) int32
  const int* q_lens;    // (S,) int32, ragged only
  const T* k_new;       // (S, Hkv, 1, hd), strides ns_*, single only
  const T* v_new;
  T* out;               // (S, Hq, Tn, hd) contiguous
  int64_t qs_s, qs_h, qs_t, ns_s, ns_h;
  int Hq, Hkv, Tn, G, R, ps, ppseq, has_new;
  float scale_log2;
};

// HD: head dim; RB: query rows per block; RAGGED: multi-token q
template <typename T, int HD, int RB, bool RAGGED>
__global__ void __launch_bounds__(NT)
paged_attention_kernel(const Args<T> a) {
  constexpr int E = (RB * HD + NT - 1) / NT;  // output elements per thread
  __shared__ __align__(16) float q_s[RB][HD];
  __shared__ float p_s[RB][NT];
  __shared__ const T* v_row[NT];
  __shared__ float m_s[RB], l_s[RB], alpha_s[RB];
  __shared__ int lim_s[RB];

  const int s = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const int c0 = blockIdx.y * RB;  // first query row of this block
  const int nrows = min(RB, a.R - c0);
  const int tid = threadIdx.x;
  const int L = a.lengths[s];
  const int cap = a.ppseq * a.ps;
  const int tmax = RAGGED ? max(a.q_lens[s] - 1, 0) : 0;
  // the last position any row of the slot sees (the mask is pos <= L for
  // a single token, pos <= L + min(t, tmax) for ragged row t)
  const int n_keys = min(L + tmax, cap - 1) + 1;
  const int ins = (!RAGGED && a.has_new) ? min(L, cap - 1) : -1;

  // the block's query rows, pre-scaled to the log2 domain; rows past
  // nrows are zeros, finite and never stored
  for (int i = tid; i < RB * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (r < nrows) {
      const int c = c0 + r;
      const int hq = h * a.G + c / a.Tn, t = c % a.Tn;
      x = to_f32(a.q[s * a.qs_s + hq * a.qs_h + t * a.qs_t + d]) *
          a.scale_log2;
    }
    q_s[r][d] = x;
  }
  if (tid < RB) {
    const int t = (c0 + tid) % a.Tn;
    lim_s[tid] = L + (RAGGED ? min(t, tmax) : 0);
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  const int* pt_row = a.pt + (int64_t)s * a.ppseq;
  const int warp = tid >> 5, lane = tid & 31;
  __syncthreads();

  for (int k0 = 0; k0 < n_keys; k0 += NT) {
    // phase 1: this thread's position, scored against every row
    const int pos = k0 + tid;
    if (pos < n_keys) {
      const T* krow;
      const T* vrow;
      if (pos == ins) {
        krow = a.k_new + s * a.ns_s + h * a.ns_h;
        vrow = a.v_new + s * a.ns_s + h * a.ns_h;
      } else {
        const int64_t page = pt_row[pos / a.ps];
        const int64_t off =
            ((page * a.ps + pos % a.ps) * a.Hkv + h) * (int64_t)HD;
        krow = a.k_pool + off;
        vrow = a.v_pool + off;
      }
      v_row[tid] = vrow;
      float sc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) sc[r] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += 8) {
        float kv[8];
        load8(krow + d0, kv);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float4 qa = *reinterpret_cast<const float4*>(&q_s[r][d0]);
          const float4 qb = *reinterpret_cast<const float4*>(&q_s[r][d0 + 4]);
          float x = sc[r];
          x = fmaf(qa.x, kv[0], x); x = fmaf(qa.y, kv[1], x);
          x = fmaf(qa.z, kv[2], x); x = fmaf(qa.w, kv[3], x);
          x = fmaf(qb.x, kv[4], x); x = fmaf(qb.y, kv[5], x);
          x = fmaf(qb.z, kv[6], x); x = fmaf(qb.w, kv[7], x);
          sc[r] = x;
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        p_s[r][tid] = pos <= lim_s[r] ? sc[r] : -INFINITY;
    } else {
      v_row[tid] = nullptr;
#pragma unroll
      for (int r = 0; r < RB; ++r) p_s[r][tid] = -INFINITY;
    }
    __syncthreads();

    // phase 2: one warp per row folds the chunk into the running max and
    // denominator.  Position 0 is visible to every row and lies in the
    // first chunk, so the max is finite from then on and no exp2
    // argument is ever -inf - -inf.
    for (int r = warp; r < RB; r += NW) {
      float cm = -INFINITY;
      for (int j = lane; j < NT; j += 32) cm = fmaxf(cm, p_s[r][j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, cm);
      float sum = 0.f;
      for (int j = lane; j < NT; j += 32) {
        const float p = exp2f(p_s[r][j] - m_new);
        p_s[r][j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float al = exp2f(m_old - m_new);
        alpha_s[r] = al;
        l_s[r] = l_s[r] * al + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // phase 3: rescale and add this chunk's p * V (a masked key has
    // p == 0 and is skipped, whatever its V row holds)
    const int nk = min(NT, n_keys - k0);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = tid + e * NT;
      if (idx < RB * HD) {
        const int r = idx / HD, d = idx % HD;
        float o = acc[e] * alpha_s[r];
#pragma unroll 8
        for (int j = 0; j < nk; ++j) {
          const float p = p_s[r][j];
          o = p != 0.f ? fmaf(p, to_f32(v_row[j][d]), o) : o;
        }
        acc[e] = o;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int idx = tid + e * NT;
    if (idx < RB * HD) {
      const int r = idx / HD, d = idx % HD;
      if (r < nrows) {
        const int c = c0 + r;
        const int hq = h * a.G + c / a.Tn, t = c % a.Tn;
        store(a.out + (((int64_t)s * a.Hq + hq) * a.Tn + t) * HD + d,
              acc[e] / l_s[r]);
      }
    }
  }
}

template <typename T, bool RAGGED>
cudaError_t launch(const Args<T>& a, int S, int hd, cudaStream_t stream) {
  const int rb = a.R == 1 ? 1 : 16;
  const long long bx = (long long)S * a.Hkv;
  const long long by = (a.R + rb - 1) / rb;
  if (bx <= 0 || bx > 0x7fffffffLL || by <= 0 || by > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)bx, (unsigned)by), block(NT);
#define DLS_PAGED_CASE(HD_)                                                \
  case HD_:                                                                \
    if (rb == 1)                                                           \
      paged_attention_kernel<T, HD_, 1, RAGGED><<<grid, block, 0, stream>>>(a); \
    else                                                                   \
      paged_attention_kernel<T, HD_, 16, RAGGED><<<grid, block, 0, stream>>>(a); \
    break;
  switch (hd) {
    DLS_PAGED_CASE(8)
    DLS_PAGED_CASE(16)
    DLS_PAGED_CASE(32)
    DLS_PAGED_CASE(64)
    DLS_PAGED_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef DLS_PAGED_CASE
  return cudaGetLastError();
}

template <typename T>
Args<T> make_args(const void* q, const void* k_pool, const void* v_pool,
                  const void* pt, const void* lengths, void* out,
                  const int64_t* q_strides, int Hq, int Hkv, int Tn,
                  int page_size, int ppseq, float sm_scale) {
  Args<T> a{};
  a.q = (const T*)q;
  a.k_pool = (const T*)k_pool;
  a.v_pool = (const T*)v_pool;
  a.pt = (const int*)pt;
  a.lengths = (const int*)lengths;
  a.out = (T*)out;
  a.qs_s = q_strides[0];
  a.qs_h = q_strides[1];
  a.qs_t = q_strides[2];
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Tn = Tn;
  a.G = Hq / Hkv;
  a.R = a.G * Tn;
  a.ps = page_size;
  a.ppseq = ppseq;
  a.scale_log2 = sm_scale * LOG2E;
  return a;
}

bool bad_geometry(int S, int Hq, int Hkv, int Tn, int page_size, int ppseq) {
  return S < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || Tn < 1 ||
         page_size < 1 || ppseq < 1;
}

}  // namespace

// Single-token paged attention (the port of `_paged_kernel`).
// dtype: 0 = float32, 1 = bfloat16.  q_strides: (s, h, t) element strides
// of q; new_strides: (s, h) of k_new and v_new (read only when has_new).
// Returns the launch's cudaError_t (0 on success); does not synchronise.
extern "C" int dls_paged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, const void* k_new,
    const void* v_new, void* out, const int64_t* q_strides,
    const int64_t* new_strides, int S, int Hq, int Hkv, int hd,
    int page_size, int ppseq, int has_new, int dtype, float sm_scale,
    void* stream) {
  if (bad_geometry(S, Hq, Hkv, 1, page_size, ppseq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args<float> a = make_args<float>(q, k_pool, v_pool, page_table, lengths,
                                     out, q_strides, Hq, Hkv, 1, page_size,
                                     ppseq, sm_scale);
    a.k_new = (const float*)k_new;
    a.v_new = (const float*)v_new;
    a.ns_s = new_strides[0];
    a.ns_h = new_strides[1];
    a.has_new = has_new;
    return (int)launch<float, false>(a, S, hd, st);
  }
  if (dtype == 1) {
    Args<__nv_bfloat16> a = make_args<__nv_bfloat16>(
        q, k_pool, v_pool, page_table, lengths, out, q_strides, Hq, Hkv, 1,
        page_size, ppseq, sm_scale);
    a.k_new = (const __nv_bfloat16*)k_new;
    a.v_new = (const __nv_bfloat16*)v_new;
    a.ns_s = new_strides[0];
    a.ns_h = new_strides[1];
    a.has_new = has_new;
    return (int)launch<__nv_bfloat16, false>(a, S, hd, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Multi-token-q paged attention (the port of `_paged_ragged_kernel`).
// Same conventions; q_lens (S,) int32.
extern "C" int dls_paged_attention_ragged_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, const void* q_lens,
    void* out, const int64_t* q_strides, int S, int Hq, int Hkv, int Tn,
    int hd, int page_size, int ppseq, int dtype, float sm_scale,
    void* stream) {
  if (bad_geometry(S, Hq, Hkv, Tn, page_size, ppseq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Args<float> a = make_args<float>(q, k_pool, v_pool, page_table, lengths,
                                     out, q_strides, Hq, Hkv, Tn, page_size,
                                     ppseq, sm_scale);
    a.q_lens = (const int*)q_lens;
    return (int)launch<float, true>(a, S, hd, st);
  }
  if (dtype == 1) {
    Args<__nv_bfloat16> a = make_args<__nv_bfloat16>(
        q, k_pool, v_pool, page_table, lengths, out, q_strides, Hq, Hkv, Tn,
        page_size, ppseq, sm_scale);
    a.q_lens = (const int*)q_lens;
    return (int)launch<__nv_bfloat16, true>(a, S, hd, st);
  }
  return (int)cudaErrorInvalidValue;
}
