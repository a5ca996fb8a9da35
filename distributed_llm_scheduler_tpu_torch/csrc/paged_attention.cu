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
// through the page table, with the softmax's running max, denominator and
// accumulator in f32 and the output in q's dtype.  GQA folds the Hq query
// heads onto Hkv KV heads: query row c of KV head h is head h*G + c/Tn at
// token c%Tn, the JAX package's (Hkv, G*Tn) order.
//
// What bounds the single-token kernel on this card: decode at the GPT-2
// serving shape (8 slots, 12 heads, hd 64, bf16, ~256 live positions per
// slot) moves the live K/V rows once, ~7 MB per call, ~2.1 us at 3.35
// TB/s; at one query row a key costs 4*hd flops for its K and V rows, 1
// flop per byte in bf16, far below the ridge.  Only moving the bytes
// sooner and more of them at once helps; tensor cores cannot, at one
// query row they would waste 15/16 of each product.
//
// Single token (`paged_split_kernel`), flash-decoding for a GPU rather
// than the TPU's (slot, page) walk, in one launch:
//   * grid (S*Hkv, n_split, row tiles): each split owns a fixed span of
//     pages_per_split whole pages of every slot (the host sizes it from
//     S*Hkv, the capacity and the SM count, never from `lengths`, so the
//     launch needs no host read of device memory).  A split whose span
//     starts past the slot's last visible position reads nothing, so
//     pages past the length are never read;
//   * staging: the block loads its span's page ids once, then copies the
//     span's K and V rows for its KV head into shared memory in tiles of
//     ~4 KB, two stages deep, with 16-byte `cp.async` (neighbouring
//     threads copy neighbouring 16 bytes of one row), so tile t+1 is in
//     flight while tile t computes.  Rows past the span's last visible
//     position are zero-filled (source size 0), never read, so nothing of
//     a masked row (a poisoned trash page included) enters a sum; the
//     insert row is copied from k_new/v_new in place of the pool's row;
//   * compute on the CUDA cores in f32: each warp owns a quarter of every
//     tile's keys and a group of LPK lanes reads one key's row (EPL
//     elements per lane: bf16x2 pairs or wider), so a warp reads whole
//     rows without bank conflicts; scores are reduced across the group by
//     shuffles, masked to -inf past the span, and folded into the warp's
//     own online softmax (exp2 on log2-scaled scores), then P*V into the
//     lanes' accumulators.  All four warps work at one query row;
//   * the four warps' (m, l, acc) merge through shared memory into the
//     split's partial, in f32;
//   * combine: the n_split blocks of a (slot, KV head) form one
//     thread-block cluster (at most 8, the portable size).  Each live
//     split stores its partial into split 0's shared memory (distributed
//     shared memory); after one cluster barrier split 0 (always live:
//     position 0 is visible) merges them in split order, all read at
//     once: out = sum_i 2^(m_i-M) acc_i / sum_i 2^(m_i-M) l_i,
//     deterministic, no atomics, no workspace and no second launch.
//
// Multi-token q in bfloat16 (`paged_ragged_tc_kernel`): a prefill chunk
// of Tn query rows per slot puts G*Tn rows on every KV head, so a key's K
// and V rows serve up to G*Tn rows and the products belong on the tensor
// cores.  At the GPT-2 serving chunk (8 slots, 12 heads, Tn 32, hd 64) the
// live K/V rows are ~8 MB, ~2.4 us at 3.35 TB/s, against ~0.2 GFLOP, ~0.2
// us on bf16 tensor cores (~3 us in f32 FMA): bytes bound it once the
// products run on the tensor cores.  At that size a block's time is a
// chain of latencies (page ids, a K/V tile, the products, the combine),
// so the design cuts the chain: the single-token kernel's split with the
// chunk's rows on `mma.sync`, in one launch:
//   * grid (S*Hkv, n_split, row tiles): a row tile is up to 8 warps' worth
//     of the KV head's G*Tn query rows in 16-row M-tiles; the KG warps of
//     an M-tile (key groups: 2 at hd <= 64, 1 at hd 128) each take 32 keys
//     of every K/V tile, so a tile's work is spread over twice the warps.
//     Split j spans pages_per_split whole pages (whole K/V tiles where the
//     page size divides the tile).  The host sizes the split from the
//     geometry alone (ops/attention.py ragged_plan): the most splits, at
//     most 8, whose footprint fits a block and whose grid fits the card in
//     one wave.  A split starting past the tile's last visible position
//     L + min(max t, tmax) reads nothing;
//   * staging: the block loads its span's page ids once, then copies K and
//     V tiles of TK keys for its KV head into dynamic shared memory by
//     16-byte `cp.async`, two stages deep, rows XOR-swizzled in 16-byte
//     chunks so `ldmatrix` and `ldmatrix.trans` read without bank
//     conflicts; every row past the tile's last visible position (and a
//     row's padding to 16 dims at hd 8) is zero-filled (source size 0)
//     and masked, so nothing of it, a poisoned trash page included,
//     enters a sum.  A position's page comes from a division by the page
//     size through its float reciprocal (corrected to exact), not an
//     integer division;
//   * compute: Q fragments straight from device memory into registers
//     (rows past G*Tn zero); S = Q K^T on `mma.sync.m16n8k16` bf16 with
//     f32 accumulation, scale * log2(e) applied to S in f32; each row's
//     mask in registers (row c = g*Tn + t sees positions <= L + min(t,
//     tmax), whatever head the row's M-tile also holds); an online
//     softmax per row with exp2; O += P V with V through ldmatrix.trans
//     and P split as hi = bf16(P) and lo = bf16(P - hi), the flash
//     kernel's remedy: one bf16 rounding of P puts outputs beyond one
//     bf16 rounding of the f32 function (tests/
//     test_torch_paged_ragged_split.py);
//   * combine: the n_split blocks of a (slot, KV head, row tile) form a
//     cluster, and block j merges the tile's j-th slice of ceil(rows /
//     n_split) rows.  Each live warp pushes its f32 (m, l, acc) of every
//     row into the shared memory of the row's merging block behind one
//     barrier; each block merges its slice from the live (split, key
//     group) partials in that order: deterministic, no atomics, no
//     workspace, no second launch.  Split 0 alone merging every row (the
//     single-token kernel's combine) cost ~5 us of a ~20 us call at the
//     serving chunk on an H100 SXM at 700 W, and its landing place grew
//     with the splits (rows * (hd + 2) * 4 bytes a split: 512 KB at 128
//     rows, hd 128 and 8 splits); a slice's takes n_split * KG *
//     ceil(rows / n_split) rows, about KG * rows whatever the split.
//
// Multi-token q in float32 (`paged_ragged_kernel`, slice 2's design): one
// thread block per (slot, KV head, tile of up to RB query rows), 128
// threads; the block walks the slot's positions in chunks of 128, one
// position per thread, reading each position's page id from the page
// table (any page size): phase 1 scores the thread's key (K row read as
// 16-byte vectors) against the block's pre-scaled query rows, masked to
// -inf; phase 2 folds the chunk into each row's running max and
// denominator, one warp per row; phase 3 adds p * V, each thread owning
// output elements, V rows read from device memory.  The walk stops after
// the last position any row of the slot can see.  It stays for the f32
// legs, held to 1e-5: TF32 tensor cores would not meet that.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 128;  // threads per block (the ragged kernel's chunk)
constexpr int NW = NT / 32;
constexpr float LOG2E = 1.4426950408889634f;
// the splits of one (slot, KV head) form a thread-block cluster, at most
// the portable cluster size; a split keeps its page ids in shared memory
constexpr int MAX_SPLITS = 8;
constexpr int MAX_SPAN_PAGES = 1024;

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

// 2 or 4 consecutive elements of a shared-memory row, as f32
__device__ __forceinline__ void load_lane(const float* p, float (&o)[2]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  o[0] = a.x; o[1] = a.y;
}
__device__ __forceinline__ void load_lane(const float* p, float (&o)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void load_lane(const __nv_bfloat16* p,
                                          float (&o)[2]) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  o[0] = f.x; o[1] = f.y;
}
__device__ __forceinline__ void load_lane(const __nv_bfloat16* p,
                                          float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// 16-byte global -> shared copy; with pred false the 16 bytes are zeroed
// (src must still be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
// the two halves of a cluster barrier: arrive without ordering memory,
// then wait for every thread of the cluster to have arrived
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
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
  int pps, n_split;     // single only: pages per split, splits per slot
  float scale_log2;
};

// -- single token: split, staged, combined -------------------------------------

// How a warp reads rows of HD elements of T: EPL consecutive elements per
// lane, LPK lanes per row (a group), NG groups per warp reading NG rows at
// once; TK keys per tile (~4 KB of K, every warp a multiple of NG keys).
template <typename T, int HD>
struct Lanes {
  static constexpr int EPL = HD >= 64 ? HD / 32 : 2;
  static constexpr int LPK = HD / EPL;
  static constexpr int NG = 32 / LPK;
  static constexpr int TK_BYTES = 4096 / (HD * (int)sizeof(T));
  static constexpr int TK = TK_BYTES > 64 ? 64
                            : (TK_BYTES < NW * NG ? NW * NG : TK_BYTES);
  static constexpr int KG = TK / (NW * NG);  // keys per group per tile
  static constexpr int CH = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr int CPR = HD / CH;             // 16-byte chunks per row
  static_assert(EPL * LPK == HD && NG * LPK == 32, "lanes do not tile a row");
  static_assert(TK % (NW * NG) == 0, "tile does not split across warps");
};

// HD: head dim; RB: query heads of the KV head's group per block.  The
// n_split blocks of one (slot, KV head, row tile) form a thread-block
// cluster, split j its rank j.
template <typename T, int HD, int RB>
__global__ void __launch_bounds__(NT)
paged_split_kernel(const Args<T> a) {
  using Ln = Lanes<T, HD>;
  constexpr int EPL = Ln::EPL, LPK = Ln::LPK, NG = Ln::NG, TK = Ln::TK;
  constexpr int KG = Ln::KG, CH = Ln::CH, CPR = Ln::CPR;
  __shared__ __align__(16) T k_s[2][TK][HD];
  __shared__ __align__(16) T v_s[2][TK][HD];
  __shared__ float m_w[NW][RB], l_w[NW][RB];
  __shared__ __align__(16) float acc_w[NW][RB][HD];
  // split 0's: every live split's (m, l, acc) per row, pushed here
  __shared__ float part_s[MAX_SPLITS][RB][2 + HD];
  extern __shared__ int page_s[];  // this split's page ids
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // this block has started

  const int s = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const int split = blockIdx.y;
  const int g0 = blockIdx.z * RB;  // first query head of the group here
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane / LPK, sub = lane % LPK;
  const int span = a.pps * a.ps;
  const int p0 = split * span;

  // independent loads, all in flight together: this split's page ids,
  // the slot's length, this lane's elements of the block's query rows
  const int first_page = split * a.pps;
  const int npg = min(a.pps, a.ppseq - first_page);
  for (int i = tid; i < npg; i += NT)
    page_s[i] = a.pt[(int64_t)s * a.ppseq + first_page + i];
  const int L = a.lengths[s];
  float q[RB][EPL];  // rows past the group are zeros, finite, never stored
#pragma unroll
  for (int r = 0; r < RB; ++r) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) q[r][e] = 0.f;
    if (g0 + r < a.G) {
      const T* qrow = a.q + s * a.qs_s + (h * a.G + g0 + r) * a.qs_h;
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        q[r][e] = to_f32(qrow[sub * EPL + e]) * a.scale_log2;
    }
  }
  const int last = min(L, a.ppseq * a.ps - 1);  // last visible position

  // a split starting past `last` sees nothing: it only keeps the
  // cluster's barriers
  if (p0 <= last) {
    const int p1 = min(p0 + span, last + 1);  // past this split's keys
    const int ins = a.has_new ? last : -1;
    __syncthreads();

    // copy tile t of the span into stage st: K and V rows of this KV head
    auto issue = [&](int t, int st) {
      const int k0 = p0 + t * TK;
      for (int c = tid; c < TK * CPR; c += NT) {
        const int row = c / CPR, ch = c % CPR;
        const int pos = k0 + row;
        const bool live = pos < p1;
        const T* ksrc = a.k_pool;
        const T* vsrc = a.v_pool;
        if (live) {
          int64_t off;
          if (pos == ins) {
            off = s * a.ns_s + h * a.ns_h + ch * CH;
            ksrc = a.k_new + off;
            vsrc = a.v_new + off;
          } else {
            const int64_t page = page_s[(pos - p0) / a.ps];
            off = ((page * a.ps + (pos - p0) % a.ps) * a.Hkv + h) *
                      (int64_t)HD + ch * CH;
            ksrc = a.k_pool + off;
            vsrc = a.v_pool + off;
          }
        }
        cp_async16(&k_s[st][row][ch * CH], ksrc, live);
        cp_async16(&v_s[st][row][ch * CH], vsrc, live);
      }
    };

    // this warp's online softmax, per query row: m is the same in every
    // lane; l and acc are partial over the lane group's keys
    float m[RB], l[RB], acc[RB][EPL];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
    }

    const int n_tiles = (p1 - p0 + TK - 1) / TK;
    issue(0, 0);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) issue(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait_1();  // tile t has landed (this thread's copies)
      __syncthreads();    // ... and every thread's
      const int st = t & 1;
      const int k0 = p0 + t * TK;
      float sc[RB][KG];
#pragma unroll
      for (int i = 0; i < KG; ++i) {
        const int row = warp * (TK / NW) + grp + NG * i;
        float kv[EPL];
        load_lane(&k_s[st][row][sub * EPL], kv);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float x = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) x = fmaf(q[r][e], kv[e], x);
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1)
            x += __shfl_xor_sync(0xffffffffu, x, o);
          sc[r][i] = k0 + row < p1 ? x : -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        float mt = sc[r][0];
#pragma unroll
        for (int i = 1; i < KG; ++i) mt = fmaxf(mt, sc[r][i]);
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
        const float m_new = fmaxf(m[r], mt);
        // a warp that has seen only masked keys keeps m = -inf: scale by
        // 2^(x - 0) then, so no exponent is ever -inf - -inf
        const float ms = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[r] - ms);
        l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < KG; ++i) {
          sc[r][i] = exp2f(sc[r][i] - ms);
          l[r] += sc[r][i];
        }
      }
#pragma unroll
      for (int i = 0; i < KG; ++i) {
        const int row = warp * (TK / NW) + grp + NG * i;
        float vv[EPL];
        load_lane(&v_s[st][row][sub * EPL], vv);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[r][e] = fmaf(sc[r][i], vv[e], acc[r][e]);
        }
      }
      __syncthreads();  // stage st is free for tile t + 2
    }

    // sum the lane groups, then the warps, into this split's partial
#pragma unroll
    for (int r = 0; r < RB; ++r) {
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], o);
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], o);
      }
      if (lane < LPK) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc_w[warp][r][sub * EPL + e] = acc[r][e];
      }
      if (lane == 0) {
        m_w[warp][r] = m[r];
        l_w[warp][r] = l[r];
      }
    }
    __syncthreads();
  }
  // every block of the cluster has started (each arrived on entry), so
  // split 0's shared memory may be written
  cluster_wait();
  if (p0 <= last) {
    // this split's slot in split 0's shared memory
    float* dst = cluster.map_shared_rank(&part_s[split][0][0], 0);
    for (int i = tid; i < RB * HD; i += NT) {
      const int r = i / HD, d = i % HD;
      // position p0 is visible to the row and lies in this split: M finite
      float M = m_w[0][r];
#pragma unroll
      for (int w = 1; w < NW; ++w) M = fmaxf(M, m_w[w][r]);
      float num = 0.f, den = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float c = exp2f(m_w[w][r] - M);  // 0 for a warp with m = -inf
        num = fmaf(c, acc_w[w][r][d], num);
        den = fmaf(c, l_w[w][r], den);
      }
      dst[r * (2 + HD) + 2 + d] = num;
      if (d == 0) {
        dst[r * (2 + HD)] = M;
        dst[r * (2 + HD) + 1] = den;
      }
    }
  }
  cluster.sync();  // every live split's partial is in split 0's memory
  if (split != 0) return;

  // split 0 (always live: position 0 is visible) merges the live splits'
  // partials in split order, all read at once
  const int n_live = last / span + 1;
  for (int i = tid; i < RB * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    if (g0 + r >= a.G) continue;
    float mj[MAX_SPLITS], lj[MAX_SPLITS], aj[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      const bool live = j < n_live;
      mj[j] = live ? part_s[j][r][0] : -INFINITY;
      lj[j] = live ? part_s[j][r][1] : 0.f;
      aj[j] = live ? part_s[j][r][2 + d] : 0.f;
    }
    float M = mj[0];
#pragma unroll
    for (int j = 1; j < MAX_SPLITS; ++j) M = fmaxf(M, mj[j]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      const float c = exp2f(mj[j] - M);  // 0 past the live splits
      num = fmaf(c, aj[j], num);
      den = fmaf(c, lj[j], den);
    }
    const int64_t row = (int64_t)s * a.Hq + h * a.G + g0 + r;
    store(a.out + row * HD + d, num / den);
  }
}

template <typename T, int HD, int RB>
cudaError_t launch_split(const Args<T>& a, dim3 grid, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = a.pps * sizeof(int);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = a.n_split;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_split_kernel<T, HD, RB>, a);
}

template <typename T>
cudaError_t launch_single(const Args<T>& a, int S, int hd,
                          cudaStream_t stream) {
  // one query head per block without GQA; else up to 4 of a group
  const int rb = a.G == 1 ? 1 : 4;
  const long long bx = (long long)S * a.Hkv;
  const long long bz = (a.G + rb - 1) / rb;
  if (bx <= 0 || bx > 0x7fffffffLL || bz > 65535 || a.n_split < 1 ||
      a.n_split > MAX_SPLITS || a.pps < 1 || a.pps > MAX_SPAN_PAGES)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)bx, (unsigned)a.n_split, (unsigned)bz);
  switch (hd) {
#define DLS_SPLIT_CASE(HD_)                                             \
  case HD_:                                                             \
    return rb == 1 ? launch_split<T, HD_, 1>(a, grid, stream)           \
                   : launch_split<T, HD_, 4>(a, grid, stream);
    DLS_SPLIT_CASE(8)
    DLS_SPLIT_CASE(16)
    DLS_SPLIT_CASE(32)
    DLS_SPLIT_CASE(64)
    DLS_SPLIT_CASE(128)
#undef DLS_SPLIT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// -- multi-token q, float32: walking the positions ------------------------------

// HD: head dim; RB: query rows per block
template <typename T, int HD, int RB>
__global__ void __launch_bounds__(NT)
paged_ragged_kernel(const Args<T> a) {
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
  const int tmax = max(a.q_lens[s] - 1, 0);
  // the last position any row of the slot sees (the mask is
  // pos <= L + min(t, tmax) for row t)
  const int n_keys = min(L + tmax, cap - 1) + 1;

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
    lim_s[tid] = L + min(t, tmax);
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
      const int64_t page = pt_row[pos / a.ps];
      const int64_t off =
          ((page * a.ps + pos % a.ps) * a.Hkv + h) * (int64_t)HD;
      const T* krow = a.k_pool + off;
      v_row[tid] = a.v_pool + off;
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

template <typename T>
cudaError_t launch_ragged(const Args<T>& a, int S, int hd,
                          cudaStream_t stream) {
  const int rb = a.R == 1 ? 1 : 16;
  const long long bx = (long long)S * a.Hkv;
  const long long by = (a.R + rb - 1) / rb;
  if (bx <= 0 || bx > 0x7fffffffLL || by <= 0 || by > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)bx, (unsigned)by), block(NT);
#define DLS_PAGED_CASE(HD_)                                                \
  case HD_:                                                                \
    if (rb == 1)                                                           \
      paged_ragged_kernel<T, HD_, 1><<<grid, block, 0, stream>>>(a);       \
    else                                                                   \
      paged_ragged_kernel<T, HD_, 16><<<grid, block, 0, stream>>>(a);      \
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

// -- multi-token q, bfloat16: tensor cores, split, staged, combined -------------

typedef __nv_bfloat16 bf16;

constexpr int TC_MAX_WARPS = 8;       // 16-row M-tiles (warps) per block
constexpr int SMEM_BLOCK = 232448;    // dynamic shared memory a block may use

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The tile geometry of head dim HD: rows padded to HDP (the mma's k is
// 16), KK k-steps of Q K^T (and 16-dim pairs of P V), TK keys per K/V
// tile (16 KB of K and V a stage at most), KW of them for each of the KG
// warps (key groups) that share an M-tile, NB 8-key blocks of a warp's S.
template <int HD>
struct Tc {
  static constexpr int HDP = HD < 16 ? 16 : HD;
  static constexpr int KK = HDP / 16;
  static constexpr int TK = HD > 64 ? 32 : 64;
  static constexpr int KW = 32;
  static constexpr int KG = TK / KW;
  static constexpr int NB = KW / 8;
  static constexpr int CPR = HDP / 8;   // 16-byte chunks of a padded row
  static constexpr int TILE = TK * HDP;  // elements of one K or V stage
};

// x / d for 0 <= x < 2^24 and d >= 1, from d's float reciprocal, made exact
// by one correction (the quotient is off by at most one)
__device__ __forceinline__ int div_exact(int x, int d, float inv_d) {
  int q = __float2int_rz(__int2float_rn(x) * inv_d);
  if (q * d > x) --q;
  else if ((q + 1) * d <= x) ++q;
  return q;
}

// Element offset of 16-byte chunk `c` of row `r` in a [rows][HDP] bf16
// tile, XOR-swizzled so that the 8 rows one `ldmatrix` phase reads at the
// same logical chunk land in 8 different 16-byte bank groups (a 128-byte
// line holds 1, 2 or 4 rows).
template <int HDP>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CH = HDP / 8;
  const int x = CH >= 8 ? c ^ (r & 7)
                : CH == 4 ? c ^ ((r >> 1) & 3)
                          : c ^ ((r >> 2) & 1);
  return r * HDP + x * 8;
}

// Bytes of dynamic shared memory of one block of `rows` query rows: K and
// V stages; the landing place of the partials (acc, then m and l) of the
// block's slice of ceil(rows / n_split) rows, one from each key group of
// each split; the split's page ids.  ops/attention.py's ragged_smem_bytes
// computes the same.
size_t ragged_tc_smem(int rows, int hd, int pps, int n_split) {
  const int hdp = hd < 16 ? 16 : hd;
  const int tk = hd > 64 ? 32 : 64;
  const int kg = tk / 32;
  const int sr = (rows + n_split - 1) / n_split;
  return (size_t)2 * 2 * tk * hdp * sizeof(bf16) +
         (size_t)n_split * kg * sr * (hd + 2) * sizeof(float) +
         (size_t)pps * sizeof(int);
}

// HD: head dim.  Block: 32 * warps threads, MT = warps / KG M-tiles of 16
// query rows of KV head h's G*Tn rows; warp w owns rows [c0 + 16 (w % MT),
// + 16) and keys [KW (w / MT), + KW) of every K/V tile.  The n_split
// blocks of one (slot, KV head, row tile) form a thread-block cluster,
// split j its rank j, and block j merges the tile's j-th slice of rows.
template <int HD>
__global__ void __launch_bounds__(32 * TC_MAX_WARPS)
paged_ragged_tc_kernel(const Args<bf16> a) {
  using C = Tc<HD>;
  constexpr int HDP = C::HDP, KK = C::KK, TK = C::TK, KW = C::KW, KG = C::KG;
  constexpr int NB = C::NB, CPR = C::CPR, TILE = C::TILE;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int mts = blockDim.x / (32 * KG);  // M-tiles of the block
  const int rows = 16 * mts;
  const int sr = (rows + a.n_split - 1) / a.n_split;  // rows of a slice
  const int n_part = a.n_split * KG;  // partials: (split, key group)
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [2][TK][HDP]
  bf16* Vs = Ks + 2 * TILE;                      // [2][TK][HDP]
  // partials of the block's slice: acc [n_part][sr][HD], m, l [n_part][sr][2]
  float* part_acc = reinterpret_cast<float*>(Vs + 2 * TILE);
  float* part_ml = part_acc + n_part * sr * HD;
  int* page_s = reinterpret_cast<int*>(part_ml + n_part * sr * 2);
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();  // this block has started

  const int s = blockIdx.x / a.Hkv, h = blockIdx.x % a.Hkv;
  const int split = blockIdx.y;
  const int c0 = blockIdx.z * rows;  // first query row of the tile
  const int nt = blockDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mt = warp % mts, kg = warp / mts;  // the warp's rows and keys
  const int span = a.pps * a.ps;
  const int p0 = split * span;
  const int cap = a.ppseq * a.ps;
  const int nrows = min(rows, a.R - c0);

  // independent loads, all in flight together: this split's page ids,
  // the slot's length and chunk length, the warp's Q fragments
  const int first_page = split * a.pps;
  const int npg = min(a.pps, a.ppseq - first_page);
  for (int i = tid; i < npg; i += nt)
    page_s[i] = a.pt[(int64_t)s * a.ppseq + first_page + i];
  const int L = a.lengths[s];
  const int tmax = max(a.q_lens[s] - 1, 0);

  // this lane's two rows (g and g + 8 of the warp's 16), as A fragments
  // read straight from device memory (bf16 pairs): fragment kk holds
  // dims [16 kk, 16 kk + 16); rows past G*Tn and dims past HD are zeros
  const int rl = mt * 16 + (lane >> 2);  // row of the tile, i = 0
  uint32_t qf[KK][4];
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = c0 + rl + 8 * i;
    const int t = c % a.Tn;
    const bool real = c < a.R;
    const bf16* qrow = a.q + s * a.qs_s + (h * a.G + c / a.Tn) * a.qs_h +
                       t * a.qs_t;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int d = kk * 16 + half * 8 + 2 * (lane & 3);
        qf[kk][2 * half + i] =
            real && d < HD ? *reinterpret_cast<const uint32_t*>(qrow + d) : 0u;
      }
    }
    lim[i] = t;  // the row's token; its last position once L is known
  }
  // the last position any row of the tile sees: L + min(max t, tmax)
  const int t0 = c0 % a.Tn;
  const int tt = t0 + nrows - 1 >= a.Tn ? a.Tn - 1 : t0 + nrows - 1;
  const int last = min(L + min(tt, tmax), cap - 1);
#pragma unroll
  for (int i = 0; i < 2; ++i) lim[i] = L + min(lim[i], tmax);

  // the warp's online softmax for its lane's two rows: running max (log2
  // domain), the lane's share of the denominator, O in the mma C layout
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};
  float acc[2 * KK][4];
#pragma unroll
  for (int n = 0; n < 2 * KK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // a split starting past `last` sees nothing: it only keeps the
  // cluster's barriers
  if (p0 <= last) {
    const int p1 = min(p0 + span, last + 1);  // past this split's keys
    __syncthreads();  // the page ids have landed

    // copy tile t of the span into stage st: K and V rows of this KV head;
    // rows at or past p1 (and the padding of a row) are zero-filled
    const float inv_ps = 1.f / (float)a.ps;
    auto issue = [&](int t, int st) {
      const int k0 = p0 + t * TK;
      bf16* kd = Ks + st * TILE;
      bf16* vd = Vs + st * TILE;
      for (int i = tid; i < TK * CPR; i += nt) {
        const int r = i / CPR, c = i % CPR;
        const int pos = k0 + r;
        const bool live = pos < p1 && c * 8 < HD;
        const bf16* ksrc = a.k_pool;
        const bf16* vsrc = a.v_pool;
        if (live) {
          const int pg = div_exact(pos - p0, a.ps, inv_ps);
          const int64_t page = page_s[pg];
          const int64_t off =
              ((page * a.ps + (pos - p0 - pg * a.ps)) * a.Hkv + h) *
                  (int64_t)HD +
              c * 8;
          ksrc += off;
          vsrc += off;
        }
        cp_async16(kd + swz<HDP>(r, c), ksrc, live);
        cp_async16(vd + swz<HDP>(r, c), vsrc, live);
      }
    };

    const int n_tiles = (p1 - p0 + TK - 1) / TK;
    issue(0, 0);
    cp_async_commit();
    for (int t = 0; t < n_tiles; ++t) {
      if (t + 1 < n_tiles) issue(t + 1, (t + 1) & 1);
      cp_async_commit();
      cp_async_wait_1();  // tile t has landed (this thread's copies)
      __syncthreads();    // ... and every thread's
      // this warp's KW keys of the tile
      const bf16* Kc = Ks + (t & 1) * TILE + kg * KW * HDP;
      const bf16* Vc = Vs + (t & 1) * TILE + kg * KW * HDP;
      const int k0 = p0 + t * TK + kg * KW;

      // S = Q K^T: K rows are B's columns; one ldmatrix.x4 gives the
      // fragments of two 8-key blocks at one 16-dim step
      float sc[NB][4];
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) {
#pragma unroll
        for (int p = 0; p < NB / 2; ++p) {
          uint32_t kf[4];
          const int key = p * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(kf, smem_u32(Kc + swz<HDP>(key, 2 * kk + ((lane >> 3) & 1))));
          mma_bf16(sc[2 * p], qf[kk], kf[0], kf[1]);
          mma_bf16(sc[2 * p + 1], qf[kk], kf[2], kf[3]);
        }
      }

      // scale in f32, then each row's mask: its own last position, and
      // the split's end (rows past it are zero-filled, not keys)
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = k0 + n * 8 + 2 * (lane & 3) + (e & 1);
          const float x = sc[n][e] * a.scale_log2;
          sc[n][e] = pos < p1 && pos <= lim[e >> 1] ? x : -INFINITY;
        }
      }

      // online softmax: the 4 lanes of a quad share each row
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[n][0], sc[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[n][2], sc[n][3]));
      }
      float base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // a row that has seen no key yet keeps m = -inf: scale by
        // 2^(x - 0) then, so no exponent is ever -inf - -inf
        base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
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
          sc[n][e] = exp2f(sc[n][e] - base[e >> 1]);
          l_r[e >> 1] += sc[n][e];
        }
      }

      // O += P V with P = hi + lo; the C layout of two S blocks is the A
      // layout of one 16-key step; V through ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NB / 2; ++kk) {
        uint32_t ph[4], pl[4];
        split_bf16x2(sc[2 * kk][0], sc[2 * kk][1], ph[0], pl[0]);
        split_bf16x2(sc[2 * kk][2], sc[2 * kk][3], ph[1], pl[1]);
        split_bf16x2(sc[2 * kk + 1][0], sc[2 * kk + 1][1], ph[2], pl[2]);
        split_bf16x2(sc[2 * kk + 1][2], sc[2 * kk + 1][3], ph[3], pl[3]);
        const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int p = 0; p < KK; ++p) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, smem_u32(Vc + swz<HDP>(key, 2 * p + (lane >> 4))));
          mma_bf16(acc[2 * p], ph, vf[0], vf[1]);
          mma_bf16(acc[2 * p], pl, vf[0], vf[1]);
          mma_bf16(acc[2 * p + 1], ph, vf[2], vf[3]);
          mma_bf16(acc[2 * p + 1], pl, vf[2], vf[3]);
        }
      }
      __syncthreads();  // stage t & 1 is free for tile t + 2
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the quad's partial denominators
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    }
  }
  // every block of the cluster has started (each arrived on entry), so
  // its shared memory may be written
  cluster_wait();
  if (p0 <= last) {
    // this warp's partial of each of its lane's rows, pushed into its
    // place in the memory of the block that merges the row's slice
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = rl + 8 * i;
      const int owner = r / sr, lr = r - owner * sr;
      const int j = split * KG + kg;
      float* dacc = cluster.map_shared_rank(part_acc + (j * sr + lr) * HD, owner);
      float* dml = cluster.map_shared_rank(part_ml + (j * sr + lr) * 2, owner);
#pragma unroll
      for (int n = 0; n < 2 * KK; ++n) {
        const int d = n * 8 + 2 * (lane & 3);
        if (d < HD)
          *reinterpret_cast<float2*>(dacc + d) =
              make_float2(acc[n][2 * i], acc[n][2 * i + 1]);
      }
      if ((lane & 3) == 0)
        *reinterpret_cast<float2*>(dml) = make_float2(m_r[i], l_r[i]);
    }
  }
  cluster.sync();  // every live partial has landed

  // block `split` merges rows [split * sr, + sr) of the tile from the live
  // splits' partials, in split order then key-group order (split 0 is
  // live: position 0 is visible to every row); each thread makes two
  // neighbouring outputs of a row
  const int n_live = (last / span + 1) * KG;
  const int r0 = split * sr;
  const int nr = min(sr, nrows - r0);
  for (int i = tid; i < nr * (HD / 2); i += nt) {
    const int lr = i / (HD / 2), d = 2 * (i % (HD / 2));
    float M = -INFINITY;
    for (int j = 0; j < n_live; ++j) M = fmaxf(M, part_ml[(j * sr + lr) * 2]);
    float x = 0.f, y = 0.f, den = 0.f;
    for (int j = 0; j < n_live; ++j) {
      const float2 ml =
          *reinterpret_cast<const float2*>(part_ml + (j * sr + lr) * 2);
      const float2 v =
          *reinterpret_cast<const float2*>(part_acc + (j * sr + lr) * HD + d);
      // 0 for a partial none of whose keys the row sees (m = -inf)
      const float c = exp2f(ml.x - M);
      x = fmaf(c, v.x, x);
      y = fmaf(c, v.y, y);
      den = fmaf(c, ml.y, den);
    }
    const int c = c0 + r0 + lr;
    const int hq = h * a.G + c / a.Tn, t = c % a.Tn;
    *reinterpret_cast<__nv_bfloat162*>(
        a.out + (((int64_t)s * a.Hq + hq) * a.Tn + t) * HD + d) =
        __floats2bfloat162_rn(x / den, y / den);
  }
}

template <int HD>
cudaError_t launch_ragged_tc(const Args<bf16>& a, dim3 grid, int warps,
                             size_t smem, cudaStream_t stream) {
  static unsigned configured = 0;  // one bit per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && !(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(paged_ragged_tc_kernel<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BLOCK);
    if (e != cudaSuccess) return e;
    configured |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = a.n_split;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_ragged_tc_kernel<HD>, a);
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

template <typename T>
cudaError_t single(const void* q, const void* k_pool, const void* v_pool,
                   const void* page_table, const void* lengths,
                   const void* k_new, const void* v_new, void* out,
                   const int64_t* q_strides, const int64_t* new_strides, int S,
                   int Hq, int Hkv, int hd, int page_size, int ppseq, int pps,
                   int has_new, float sm_scale, cudaStream_t stream) {
  Args<T> a = make_args<T>(q, k_pool, v_pool, page_table, lengths, out,
                           q_strides, Hq, Hkv, 1, page_size, ppseq, sm_scale);
  a.k_new = (const T*)k_new;
  a.v_new = (const T*)v_new;
  a.ns_s = new_strides[0];
  a.ns_h = new_strides[1];
  a.has_new = has_new;
  a.pps = pps;
  a.n_split = pps < 1 ? 0 : (ppseq + pps - 1) / pps;
  return launch_single<T>(a, S, hd, stream);
}

}  // namespace

// Single-token paged attention (the port of `_paged_kernel`).
// dtype: 0 = float32, 1 = bfloat16.  q_strides: (s, h, t) element strides
// of q; new_strides: (s, h) of k_new and v_new (read only when has_new).
// pages_per_split: the span of each split, at most 1024 pages, in at
// most 8 splits (ceil(ppseq / pages_per_split)).  One launch; returns its
// cudaError_t (0 on success); does not synchronise.
extern "C" int dls_paged_attention_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, const void* k_new,
    const void* v_new, void* out, const int64_t* q_strides,
    const int64_t* new_strides, int S, int Hq, int Hkv, int hd,
    int page_size, int ppseq, int pages_per_split, int has_new, int dtype,
    float sm_scale, void* stream) {
  if (bad_geometry(S, Hq, Hkv, 1, page_size, ppseq))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)single<float>(q, k_pool, v_pool, page_table, lengths, k_new,
                              v_new, out, q_strides, new_strides, S, Hq,
                              Hkv, hd, page_size, ppseq, pages_per_split,
                              has_new, sm_scale, st);
  if (dtype == 1)
    return (int)single<__nv_bfloat16>(
        q, k_pool, v_pool, page_table, lengths, k_new, v_new, out,
        q_strides, new_strides, S, Hq, Hkv, hd, page_size, ppseq,
        pages_per_split, has_new, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

// Multi-token-q paged attention (the port of `_paged_ragged_kernel`) in
// float32, walking the positions on the CUDA cores.  Same conventions;
// q_lens (S,) int32; dtype must be 0 (bfloat16 runs on the tensor cores,
// dls_paged_attention_ragged_tc_fwd).
extern "C" int dls_paged_attention_ragged_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, const void* q_lens,
    void* out, const int64_t* q_strides, int S, int Hq, int Hkv, int Tn,
    int hd, int page_size, int ppseq, int dtype, float sm_scale,
    void* stream) {
  if (bad_geometry(S, Hq, Hkv, Tn, page_size, ppseq) || dtype != 0)
    return (int)cudaErrorInvalidValue;
  Args<float> a = make_args<float>(q, k_pool, v_pool, page_table, lengths,
                                   out, q_strides, Hq, Hkv, Tn, page_size,
                                   ppseq, sm_scale);
  a.q_lens = (const int*)q_lens;
  return (int)launch_ragged<float>(a, S, hd,
                                   reinterpret_cast<cudaStream_t>(stream));
}

// Multi-token-q paged attention in bfloat16 on the tensor cores.  Same
// conventions, with the launch's geometry as ops/attention.py's
// ragged_plan sizes it: warps, the warps of a block (at most 8, a multiple
// of the key groups, 2 at hd <= 64 and 1 at hd 128; a block holds warps /
// key groups M-tiles of 16 query rows, and the row tiles follow from
// G*Tn); pages_per_split (1-1024) and n_split = ceil(ppseq /
// pages_per_split) (1-8, one cluster), whose footprint (ragged_tc_smem)
// must fit a block.  Any other geometry returns cudaErrorInvalidValue and
// runs nothing; else one launch, whose cudaError_t is returned; does not
// synchronise.
extern "C" int dls_paged_attention_ragged_tc_fwd(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* lengths, const void* q_lens,
    void* out, const int64_t* q_strides, int S, int Hq, int Hkv, int Tn,
    int hd, int page_size, int ppseq, int warps, int pages_per_split,
    int n_split, float sm_scale, void* stream) {
  const int kg = hd > 64 ? 1 : 2;  // Tc<hd>::KG
  if (bad_geometry(S, Hq, Hkv, Tn, page_size, ppseq) || warps < kg ||
      warps > TC_MAX_WARPS || warps % kg != 0 || pages_per_split < 1 ||
      pages_per_split > MAX_SPAN_PAGES || n_split < 1 ||
      n_split > MAX_SPLITS ||
      n_split != (ppseq + pages_per_split - 1) / pages_per_split)
    return (int)cudaErrorInvalidValue;
  const int rows = 16 * (warps / kg);  // query rows of a block
  const size_t smem = ragged_tc_smem(rows, hd, pages_per_split, n_split);
  Args<bf16> a = make_args<bf16>(q, k_pool, v_pool, page_table, lengths, out,
                                 q_strides, Hq, Hkv, Tn, page_size, ppseq,
                                 sm_scale);
  a.q_lens = (const int*)q_lens;
  a.pps = pages_per_split;
  a.n_split = n_split;
  const long long bx = (long long)S * Hkv;
  const long long bz = (a.R + rows - 1) / rows;
  if (smem > (size_t)SMEM_BLOCK || bx > 0x7fffffffLL || bz > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)bx, (unsigned)n_split, (unsigned)bz);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return (int)launch_ragged_tc<8>(a, grid, warps, smem, st);
    case 16: return (int)launch_ragged_tc<16>(a, grid, warps, smem, st);
    case 32: return (int)launch_ragged_tc<32>(a, grid, warps, smem, st);
    case 64: return (int)launch_ragged_tc<64>(a, grid, warps, smem, st);
    case 128: return (int)launch_ragged_tc<128>(a, grid, warps, smem, st);
  }
  return (int)cudaErrorInvalidValue;
}
