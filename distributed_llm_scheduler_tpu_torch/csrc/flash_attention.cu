// Causal / full flash-attention forward for Hopper (sm_90a), plain C entry.
//
// Replaces the Pallas TPU kernel `_flash_kernel`, launched by `_flash_mha`
// (distributed_llm_scheduler_tpu/ops/attention.py:59 and :152).  It computes
// the same function, softmax(q k^T * scale [causal mask]) v over
// (B, Hq, T, hd), with the online softmax's running max, denominator and
// accumulator in f32 and the output in the input dtype.  K and V may have
// fewer heads than q (grouped-query attention): query head h reads KV head
// h / (Hq / Hkv), the mapping of `repeat_interleave` and `jnp.repeat`, in
// place, so no repeated copy of K and V is ever made.
//
// Two kernels, one per input type:
//
// bfloat16: `flash_fwd_tc_kernel`, on the tensor cores.
//   * one block of 4 warps per (b, query head, 64-row Q tile); each warp
//     owns 16 query rows.  Q tiles are issued last-first, so under `causal`
//     the longest (most K/V tiles) blocks start first;
//   * Q is staged once through shared memory into registers (`ldmatrix`);
//     K/V tiles of 64 keys x hd are copied into dynamic shared memory by
//     16-byte `cp.async` in two stages, so tile j+1 loads while tile j
//     computes.  Rows are XOR-swizzled in 16-byte chunks, so `ldmatrix` and
//     `ldmatrix.trans` read without bank conflicts;
//   * S = Q K^T and O += P V run on `mma.sync.m16n8k16` (bf16 in, f32
//     accumulate).  S stays in registers; scale * log2(e) is applied in
//     f32, the masks only on the diagonal tile and the ragged last tile,
//     and the online softmax (exp2) reduces over the 4 lanes that share a
//     row in the mma layout;
//   * P is split as hi = bf16(P) and lo = bf16(P - hi), and O += hi V +
//     lo V.  A single bf16 rounding of P (the usual FlashAttention-2 step)
//     puts ~10% of the outputs more than 2^-8 |x| off the exact value;
//     the split keeps ~16 bits of P, so the output, rounded to bf16 once
//     at the end, is as close to the f32 function as the TPU kernel's
//     (which casts q, k and v to f32 and keeps P in f32).  The
//     denominator sums the f32 P.
//   Why `mma.sync` and not `wgmma` with TMA: at the main paths' shapes a
//   block walks at most 8 K/V tiles and the grid is 96-256 blocks, so
//   latency, overlap and grid fill set the time, not the peak tensor rate;
//   and the callers hand strided views (heads of a fused qkv product),
//   which `cp.async` reads directly.
//
// float32: `flash_fwd_kernel`, f32 FMA on the CUDA cores (four threads
//   per query row, K/V tiles in shared memory).  It stays for the f32
//   correctness legs, which hold the card to 1e-4 of the CPU: TF32 tensor
//   cores would not meet that.
//
// Both take (b, h, t) strides with a unit stride on the head dim and mask
// the ragged tail, so any T >= 1 works.  The bf16 kernel's copies need a
// 16-byte aligned base and (b, h, t) strides; the wrapper checks that.
//
// What bounds it on this card: bytes.  q, k, v read once and o written
// once: at GPT-2's (1, 12, 512, 64) bf16, 3.15 MB, 0.94 us at 3.35 TB/s,
// against 0.41 us of tensor-core work; at Llama-3 8B's (1, 32, 512, 128)
// with 8 KV heads, 10.5 MB, 3.13 us.  The design reads each K/V tile from
// device memory once per block (the G query heads of a KV head re-read it
// from the 50 MB L2), never writes the (T, T) scores, and keeps the
// products on the tensor cores so the arithmetic stays below the copies.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;

// -- float32: FMA kernel ------------------------------------------------------

constexpr int BM = 64;        // query rows per block
constexpr int THREADS = 256;  // 4 threads per query row

// HD: head dim; BN: key rows per shared-memory tile.
template <int HD, int BN>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int H, int group, int Tlen, int n_qtiles,
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

  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  // q row slice, pre-scaled by scale*log2(e) so the softmax uses exp2
  float qr[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = (g * 4 + part) * 4 + e;
      qr[g][e] = row_ok ? qb[row * qst + d] * scale_log2 : 0.f;
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
      Ks[i] = ok ? kb[t * kst + d] : 0.f;
      Vs[i] = ok ? vb[t * vst + d] : 0.f;
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
    float* ob = o + b * osb + h * osh + row * ost;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) ob[(g * 4 + part) * 4 + e] = acc[g][e] * inv;
  }
}

// -- bfloat16: tensor-core kernel ---------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int TC_BM = 64;        // query rows per block: 4 warps x 16
constexpr int TC_BN = 64;        // keys per K/V tile
constexpr int TC_THREADS = 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with pred false the 16 bytes are zeroed
// (src must still be a valid address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 values as one bf16x2 register (x in the low half), and the
// bf16x2 of what each rounding left over
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// Element offset of 16-byte chunk `c` of row `r` in a [rows][HD] bf16
// tile, XOR-swizzled so that the 8 rows one `ldmatrix` phase reads at the
// same logical chunk land in 8 different 16-byte bank groups.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CH = HD / 8;  // chunks per row
  const int x = CH >= 8 ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3));  // HD 32: 2 rows per 128 B
  return r * HD + x * 8;
}

// rows [row0, row0 + 64) of a (T, HD) matrix with row stride `rs` into a
// swizzled shared tile; rows at or past Tlen are zero-filled
template <int HD>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, int64_t rs,
                                          int row0, int Tlen, int tid) {
  constexpr int CH = HD / 8;
  constexpr int PER_THREAD = TC_BN * CH / TC_THREADS;
  static_assert(TC_BN * CH % TC_THREADS == 0, "tile does not split evenly");
#pragma unroll
  for (int it = 0; it < PER_THREAD; ++it) {
    const int i = it * TC_THREADS + tid;
    const int r = i / CH, c = i % CH;
    const int t = row0 + r;
    const bool ok = t < Tlen;
    cp_async16(smem_u32(s + swz<HD>(r, c)), g + (ok ? t : 0) * rs + c * 8, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    int H, int group, int Tlen, int n_qtiles,
                    int64_t qsb, int64_t qsh, int64_t qst,
                    int64_t ksb, int64_t ksh, int64_t kst,
                    int64_t vsb, int64_t vsh, int64_t vst,
                    int64_t osb, int64_t osh, int64_t ost,
                    int causal, float scale_log2) {
  constexpr int TILE = TC_BN * HD;  // elements of one K or V tile
  constexpr int KK = HD / 16;       // k-steps of Q K^T; dim pairs of P V
  constexpr int NB = TC_BN / 8;     // 8-key column blocks of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [2][TILE]
  bf16* Vs = Ks + 2 * TILE;                      // [2][TILE]
  bf16* Qs = Ks + TILE;  // Q is staged in K's second stage before the walk

  // last Q tile first; the heads of one KV head are adjacent
  const int BH = gridDim.x / n_qtiles;
  const int bh = blockIdx.x % BH;
  const int qt = n_qtiles - 1 - blockIdx.x / BH;
  const int b = bh / H, h = bh % H, hk = h / group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = qt * TC_BM;

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + hk * ksh;
  const bf16* vb = v + b * vsb + hk * vsh;

  const int kv_end = causal ? min(q0 + TC_BM, Tlen) : Tlen;
  const int n_kt = (kv_end + TC_BN - 1) / TC_BN;

  load_tile<HD>(Qs, qb, qst, q0, Tlen, tid);
  load_tile<HD>(Ks, kb, kst, 0, Tlen, tid);
  load_tile<HD>(Vs, vb, vst, 0, Tlen, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // the warp's 16 Q rows as KK A-fragments (rows lane&15, chunk +lane>>4)
  uint32_t qf[KK][4];
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
    ldmatrix_x4(qf[kk],
                smem_u32(Qs + swz<HD>(warp * 16 + (lane & 15), 2 * kk + (lane >> 4))));
  __syncthreads();  // Qs is free: K/V tile 1 may land there

  float acc[2 * KK][4];  // O: 8-dim column blocks, mma C layout
#pragma unroll
  for (int n = 0; n < 2 * KK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // this lane's two rows (g and g + 8 of the warp's 16): running max in the
  // log2 domain and the lane's share of the denominator
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  const int row_a = q0 + warp * 16 + (lane >> 2);

  for (int j = 0; j < n_kt; ++j) {
    if (j + 1 < n_kt) {  // prefetch the next tile into the other stage
      const int nxt = ((j + 1) & 1) * TILE;
      load_tile<HD>(Ks + nxt, kb, kst, (j + 1) * TC_BN, Tlen, tid);
      load_tile<HD>(Vs + nxt, vb, vst, (j + 1) * TC_BN, Tlen, tid);
      cp_async_commit();
    }
    const bf16* Kc = Ks + (j & 1) * TILE;
    const bf16* Vc = Vs + (j & 1) * TILE;
    const int k0 = j * TC_BN;

    // S = Q K^T: K rows are B's columns; one ldmatrix.x4 gives the
    // fragments of two 8-key blocks at one 16-dim step
    float s[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int p = 0; p < NB / 2; ++p) {
        uint32_t kf[4];
        const int key = p * 16 + (lane & 7) + ((lane >> 4) << 3);
        ldmatrix_x4(kf, smem_u32(Kc + swz<HD>(key, 2 * kk + ((lane >> 3) & 1))));
        mma_bf16(s[2 * p], qf[kk], kf[0], kf[1]);
        mma_bf16(s[2 * p + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // scale in f32; mask only where a key can lie past the row or past T
    const bool masked = (causal && k0 + TC_BN - 1 > q0) || k0 + TC_BN > Tlen;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int col = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
          const int row = row_a + ((e >> 1) << 3);
          if (col >= Tlen || (causal && col > row)) x = -INFINITY;
        }
        s[n][e] = x;
      }
    }

    // online softmax: the 4 lanes of a quad share each row
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];  // a row with no key yet
      const float alpha = exp2f(m_r[i] - base[i]);
      m_r[i] = mx[i];
      l_r[i] *= alpha;
#pragma unroll
      for (int n = 0; n < 2 * KK; ++n) {
        acc[n][2 * i] *= alpha;
        acc[n][2 * i + 1] *= alpha;
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - base[e >> 1]);
        l_r[e >> 1] += s[n][e];
      }
    }

    // O += P V with P = hi + lo; the C layout of two S blocks is the A
    // layout of one 16-key step; V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < NB / 2; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16x2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16x2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
      for (int p = 0; p < KK; ++p) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_u32(Vc + swz<HD>(key, 2 * p + (lane >> 4))));
        mma_bf16(acc[2 * p], ph, vf[0], vf[1]);
        mma_bf16(acc[2 * p], pl, vf[0], vf[1]);
        mma_bf16(acc[2 * p + 1], ph, vf[2], vf[3]);
        mma_bf16(acc[2 * p + 1], pl, vf[2], vf[3]);
      }
    }

    if (j + 1 < n_kt) cp_async_wait_all();
    __syncthreads();  // this stage consumed, the next one landed
  }

  // the quad's partial denominators; one rounding to bf16 on the way out
  bf16* ob = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_r[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = row_a + 8 * i;
    if (row < Tlen) {
#pragma unroll
      for (int n = 0; n < 2 * KK; ++n) {
        const int d = n * 8 + 2 * (lane & 3);
        *reinterpret_cast<__nv_bfloat162*>(ob + row * ost + d) =
            __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, group, Tlen, hd;
  const int64_t* st;
  int causal;
  float scale_log2;
  cudaStream_t stream;
};

#define DLS_FLASH_ARGS(T)                                                    \
  (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o, a.H, a.group, a.Tlen, \
      n_qtiles, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5],         \
      a.st[6], a.st[7], a.st[8], a.st[9], a.st[10], a.st[11], a.causal,       \
      a.scale_log2

template <int HD, int BN>
cudaError_t launch_f32(const Args& a) {
  const int n_qtiles = (a.Tlen + BM - 1) / BM;
  const long long blocks = (long long)a.B * a.H * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel<HD, BN><<<(unsigned)blocks, THREADS, 0, a.stream>>>(
      DLS_FLASH_ARGS(float));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16(const Args& a) {
  constexpr int smem = 4 * TC_BN * HD * (int)sizeof(bf16);  // K, V x 2 stages
  static unsigned configured = 0;  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(flash_fwd_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    configured |= 1u << dev;
  }
  const int n_qtiles = (a.Tlen + TC_BM - 1) / TC_BM;
  const long long blocks = (long long)a.B * a.H * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_tc_kernel<HD><<<(unsigned)blocks, TC_THREADS, smem, a.stream>>>(
      DLS_FLASH_ARGS(bf16));
  return cudaGetLastError();
}

#undef DLS_FLASH_ARGS

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and o have H heads, k and v Hkv
// (H a multiple of Hkv).  strides: 12 element strides, (b, h, t) for q, k,
// v and o in that order; the head dim has unit stride.  Returns the
// launch's cudaError_t (0 on success); does not synchronise.
extern "C" int dls_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int Hkv, int Tlen, int hd,
                                       const int64_t* strides, int dtype,
                                       int causal, float sm_scale,
                                       void* stream) {
  if (B < 1 || Tlen < 1 || Hkv < 1 || H < 1 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, H, H / Hkv, Tlen, hd, strides, causal,
               sm_scale * LOG2E, reinterpret_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    switch (hd) {
      case 32: return (int)launch_f32<32, 64>(a);
      case 64: return (int)launch_f32<64, 64>(a);
      case 128: return (int)launch_f32<128, 32>(a);
    }
  } else if (dtype == 1) {
    switch (hd) {
      case 32: return (int)launch_bf16<32>(a);
      case 64: return (int)launch_bf16<64>(a);
      case 128: return (int)launch_bf16<128>(a);
    }
  }
  return (int)cudaErrorInvalidValue;
}
