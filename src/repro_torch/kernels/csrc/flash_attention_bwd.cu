// Backward of the forward attention in flash_attention.cu: dQ, dK and dV of
// causal or sliding-window grouped-query attention with queries aligned to
// the end of the keys (offset Sk - Sq), the same masks as the forward.
//
// The JAX package has no Pallas backward (its CPU path differentiates the
// blocked jnp attention, src/repro/kernels/ops.py `causal_blocked`), so this
// kernel has no TPU counterpart; it is held to autograd through the plain
// version (kernels/ref.py `flash_attention_ref`).
//
// Algorithm: FlashAttention-2's. P is recomputed from the log-sum-exp the
// forward saved (exp2 domain: p = exp2(s * scale * log2(e) - lse)), never
// stored. Three kernels on one stream:
//
// 1. delta: D_i = sum_d dO_id * O_id in f32, 8 lanes per query row.
// 2. dK/dV: one block per (batch, KV head, 64-key tile). It loops over every
//    query head of the GQA group and over the query tiles that can see its
//    keys, and keeps dK and dV of its 64 keys in registers, so they are
//    summed over the group with no atomics and the same bits on every run:
//      S^T = K Q^T, P^T = exp2(S^T c - lse), dP^T = V dO^T,
//      dS^T = P^T (dP^T - D), dV += P^T dO, dK += dS^T Q.
// 3. dQ: one block per (batch, query head, 64-query tile), looping over the
//    key tiles the tile can see: S = Q K^T, dP = dO V^T, dS = P (dP - D),
//    dQ += dS K.
// dK and dQ are scaled by the softmax scale at the store. Every output
// element is written once by one thread: the same inputs give the same bits.
//
// Bound on an H100: operations. The work needs five products of 2 * D flops
// per visible (query, key) pair (S, dP, dV, dK, dQ) on the bf16 tensor cores
// (989 TFLOP/s dense): 85.9 GFLOP, 0.087 ms, at qwen1.5-0.5b's training
// shape (B1 S4096 H16/KH16 D64, causal). This design runs seven, as the dQ
// kernel recomputes S and dP. The design, for Hopper:
//
// - Every product is a warpgroup MMA (`wgmma.mma_async`, sm_90a) issued by
//   one warpgroup (128 threads) per block on 64 x 64 tiles, bf16 operands
//   and f32 accumulators. S^T and dP^T (dK/dV kernel) and S and dP (dQ
//   kernel) read both operands K-major from shared memory; dV, dK and dQ
//   take P^T, dS^T and dS from registers (the accumulator fragments rounded
//   to bf16, in the A operand's layout) and read dO, Q and K MN-major from
//   the same tiles: nothing is transposed in memory. Every tile is stored in
//   the swizzled layout its descriptors name (hopper.cuh `SwTile`).
// - The tiles that stream (Q and dO with their lse and delta rows in the
//   dK/dV kernel, over the group's heads and query tiles as one sequence;
//   K and V in the dQ kernel) go through a two-stage ring in shared memory,
//   filled by `cp.async`: the next tile's copy is issued before the current
//   tile's products and lands while they run.
// - S and dP are committed as two groups, so P is computed while dP is
//   still on the tensor cores. Masks are applied only on tiles that cross
//   the causal diagonal, the window's edge, Sq or Sk; tiles with no visible
//   pair are never visited.
// - Both grids run the heaviest causal tiles first (key tile 0 sees every
//   query; the last query tile sees every key), so the last wave is short.
// - P and dS are rounded to bf16 before the products that take them, as the
//   forward rounds P. Head dim 120 runs the 128 tiles with zero columns.
// - dQ is a separate kernel (seven products), not fused into the dK/dV
//   kernel (five) with a deterministic reduction. Fused, each 64-key block
//   would write an f32 dQ partial for every query it sees, to be summed in
//   key order by a second pass: at qwen's shape 16 * 64 * 2048 * 64 * 4
//   bytes = 0.54 GB written and read again, 0.32 ms at 3.35 TB/s, against
//   the 0.035 ms the two recomputed products take at the bf16 peak. Adding
//   the partials in place in key order would make each key block wait for
//   the one before it on every query tile, which serialises the causal
//   grid. FlashAttention-2 and -3 fuse with f32 atomics, whose order, and
//   so whose bits, vary from run to run.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8; no spills): registers per
// thread dK/dV 232 / 168 / 130 and dQ 158 / 125 / 120 at D 128 / 64 / 32,
// delta 32. Shared memory per block: dK/dV 100,352 / 51,200 / 26,624 bytes,
// dQ 99,328 / 50,176 / 25,600. So at D = 64 three dK/dV blocks (registers)
// and four dQ blocks share an SM; at D = 128 two of each.
//
// What is left between this design and the bound (tools/flash_bwd_variants.py
// on an H100 at qwen's shape; numbers in PERF.md): a warpgroup's tile is a
// chain (products, wait, exponentials, wait, products, wait) that takes
// several times its tensor-core time, and the blocks that share an SM hide
// only part of it (one block an SM is 1.7 times slower than three or
// four). Dropping the products after P saves their time at the peak rate,
// dropping the streamed loads 18 %, the exponentials 5 %. Variants that
// were built and timed and were slower: each tile as two 32-wide halves,
// 128-wide tiles (two blocks an SM), issuing dV before dS is made, and a
// third ring stage that lets a tile's dV and dK run under the next tile's
// S^T. A producer warp with TMA, two consumer warpgroups per block and
// `setmaxnreg` are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;   // one warpgroup
constexpr int kRows = 64;       // rows per block: keys (dK/dV) or queries (dQ)
constexpr int kBQ = 64;         // queries per streamed tile of the dK/dV kernel
constexpr int kBK = 64;         // keys per streamed tile of the dQ kernel

__device__ __forceinline__ bool visible(int kp, int qp, int Sk, int causal, int window) {
  return kp < Sk && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

__device__ __forceinline__ __nv_bfloat16* align1024(unsigned char* p) {
  return reinterpret_cast<__nv_bfloat16*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~uintptr_t(1023));
}

// Stores the warpgroup's 64 x D accumulator (times `mul`) as bf16 rows
// row0 .. row0 + 63 (below `limit`, columns below DR) at `dst` (row stride
// `ss`), staged through the tile `stage` (SwTile<D, 64> layout, free) so
// that every global store is 16 bytes wide. Each warp stages and stores
// its own 16 rows.
template <int D, int DR>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul,
                                           __nv_bfloat16* stage, __nv_bfloat16* dst,
                                           int64_t ss, int row0, int limit, int warp,
                                           int lane) {
  using L = SwTile<D, kRows>;
  constexpr int CH = D / 8, RS = 32 / CH;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<__nv_bfloat162*>(stage + L::off(warp * 16 + g + 8 * hr, dt) + t4 * 2) =
          __floats2bfloat162_rn(acc[dt][2 * hr] * mul, acc[dt][2 * hr + 1] * mul);
  __syncwarp();
  const int c = lane % CH, r0 = lane / CH;
  __nv_bfloat16* p = dst + (int64_t)(row0 + warp * 16 + r0) * ss + c * 8;
#pragma unroll
  for (int i = 0; i < 16 / RS; ++i) {
    const int r = warp * 16 + r0 + i * RS;
    if (row0 + r < limit && c < DR / 8)
      *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(stage + L::off(r, c));
    p += RS * ss;
  }
}

// Rounds a 64 x (16 KK) accumulator to bf16 A fragments, k16 step by step.
template <int KK>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KK][4], const float (&s)[2 * KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O): 8 lanes per (b, h, query) row, 16-byte loads
// ---------------------------------------------------------------------------
constexpr int kDeltaLanes = 8;
constexpr int kDeltaRows = kThreads / kDeltaLanes;   // rows per block

__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int H, int Sq, int D, int64_t rows,
                       int64_t o_sb, int64_t o_ss, int64_t o_sh,
                       int64_t d_sb, int64_t d_ss, int64_t d_sh) {
  const int64_t row = (int64_t)blockIdx.x * kDeltaRows + threadIdx.x / kDeltaLanes;
  const int sub = threadIdx.x % kDeltaLanes;
  float acc = 0.f;
  if (row < rows) {
    const int64_t bh = row / Sq;
    const int s = (int)(row - bh * Sq);
    const int b = (int)(bh / H), h = (int)(bh - (int64_t)b * H);
    const __nv_bfloat16* op = o + b * o_sb + (int64_t)s * o_ss + h * o_sh;
    const __nv_bfloat16* dp = dout + b * d_sb + (int64_t)s * d_ss + h * d_sh;
    for (int c = sub * 8; c < D; c += kDeltaLanes * 8) {
      const uint4 x = *reinterpret_cast<const uint4*>(op + c);
      const uint4 y = *reinterpret_cast<const uint4*>(dp + c);
      const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 u = __bfloat1622float2(xa[i]), w = __bfloat1622float2(ya[i]);
        acc = fmaf(u.x, w.x, fmaf(u.y, w.y, acc));
      }
    }
  }
#pragma unroll
  for (int m = kDeltaLanes / 2; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (row < rows && sub == 0) delta[row] = acc;
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float *lse, *delta;
  __nv_bfloat16 *dq, *dk, *dv;
  int B, H, KH, Sq, Sk;
  // (batch, seq, head) strides in elements of q, k, v, o, dO, dQ, dK, dV
  int64_t st[8][3];
  float scale, scale_log2;
  int causal, window;
};

// ---------------------------------------------------------------------------
// 2. dK, dV: one block per (b, kv head, 64 keys)
// ---------------------------------------------------------------------------
template <int D, int DR>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const Args a) {
  using LK = SwTile<D, kRows>;   // K, V
  using LQ = SwTile<D, kBQ>;     // Q, dO
  constexpr int NQ = kBQ / 8;    // n8 column groups of S^T (queries)
  constexpr int DT = D / 8;      // n8 column groups of dK, dV
  constexpr int KS = D / 16;     // k16 steps of S^T and dP^T
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sK = align1024(smem_raw);
  __nv_bfloat16* sV = sK + LK::kElems;
  __nv_bfloat16* sQ = sV + LK::kElems;          // [2][LQ]
  __nv_bfloat16* sO = sQ + 2 * LQ::kElems;      // dO, [2][LQ]
  float* sL = reinterpret_cast<float*>(sO + 2 * LQ::kElems);   // lse, [2][kBQ]
  float* sD = sL + 2 * kBQ;                                     // delta, [2][kBQ]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bkh = blockIdx.x;
  const int b = bkh / a.KH, kh = bkh - b * a.KH;
  const int group = a.H / a.KH;
  const int k0 = blockIdx.y * kRows;
  const int off = a.Sk - a.Sq;

  // queries that may see a key of this tile: [q_lo, q_hi); the streamed
  // items are (head j of the group, query tile from q_lo), head-major
  const int k_last = min(k0 + kRows, a.Sk) - 1;
  const int q_lo = max(a.causal ? k0 - off : 0, 0);
  const int q_hi = min(a.window >= 0 ? k_last + a.window - off : a.Sq, a.Sq);
  const int nq = q_hi > q_lo ? (q_hi - q_lo + kBQ - 1) / kBQ : 0;
  const int n_items = group * nq;

  auto load_item = [&](int i, int stage) {
    const int j = i / nq, h = kh * group + j;
    const int q0 = q_lo + (i - j * nq) * kBQ;
    load_tile<D, DR, kBQ, kThreads>(sQ + stage * LQ::kElems,
                                   a.q + b * a.st[0][0] + h * a.st[0][2], a.st[0][1], q0,
                                   a.Sq, tid);
    load_tile<D, DR, kBQ, kThreads>(sO + stage * LQ::kElems,
                                   a.dout + b * a.st[4][0] + h * a.st[4][2], a.st[4][1], q0,
                                   a.Sq, tid);
    // rows past Sq read as 0; the masks drop them
    const int64_t row = ((int64_t)b * a.H + h) * a.Sq + q0;
    if (tid < 2 * kBQ) {
      const int r = tid % kBQ;
      const bool ok = q0 + r < a.Sq;
      const float* src = tid < kBQ ? a.lse : a.delta;
      float* dst = (tid < kBQ ? sL : sD) + stage * kBQ + r;
      cp_async4(smem_u32(dst), ok ? src + row + r : src, ok);
    }
  };

  if (n_items > 0) {
    load_tile<D, DR, kRows, kThreads>(sK, a.k + b * a.st[1][0] + kh * a.st[1][2], a.st[1][1],
                                      k0, a.Sk, tid);
    load_tile<D, DR, kRows, kThreads>(sV, a.v + b * a.st[2][0] + kh * a.st[2][2], a.st[2][1],
                                      k0, a.Sk, tid);
    load_item(0, 0);   // K, V and the first item: one group
  }
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  // accumulator fragments of S^T: warp w holds keys k0 + 16 w + g and + 8,
  // queries 8 nt + 2 t4 and + 1 of every n8 group nt
  const int kp0 = k0 + warp * 16 + g;
  const uint32_t k_base = smem_u32(sK), v_base = smem_u32(sV);
  for (int it = 0; it < n_items; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_items) load_item(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // item `it` (and K, V) have landed
    fence_async_smem();
    __syncthreads();
    const uint32_t q_base = smem_u32(sQ + stage * LQ::kElems);
    const uint32_t o_base = smem_u32(sO + stage * LQ::kElems);
    const float* lse = sL + stage * kBQ;
    const float* del = sD + stage * kBQ;
    const int q0 = q_lo + (it % nq) * kBQ;

    // S^T = K Q^T and dP^T = V dO^T, 64 x kBQ each, as two groups
    float st[NQ][4], dpt[NQ][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_m64n64(&st[0][0], LK::kmajor(k_base, ks), LQ::kmajor(q_base, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_m64n64(&dpt[0][0], LK::kmajor(v_base, ks), LQ::kmajor(o_base, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();   // S^T has landed; dP^T may still run

    // P^T = exp2(S^T c - lse), masked on tiles that cross an edge
    const bool edge = q0 + kBQ > a.Sq || k0 + kRows > a.Sk ||
                      (a.causal && k0 + kRows - 1 > q0 + off) ||
                      (a.window >= 0 && k0 <= q0 + kBQ - 1 + off - a.window);
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const float2 l = *reinterpret_cast<const float2*>(lse + nt * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = fast_exp2(fmaf(st[nt][e], a.scale_log2, (e & 1) ? -l.y : -l.x));
        if (edge) {
          const int qi = q0 + nt * 8 + 2 * t4 + (e & 1);
          if (!(qi < a.Sq && visible(kp0 + 8 * (e >> 1), qi + off, a.Sk, a.causal, a.window)))
            p = 0.f;
        }
        st[nt][e] = p;
      }
    }
    wgmma_wait<0>();   // dP^T has landed
    // dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const float2 d = *reinterpret_cast<const float2*>(del + nt * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[nt][e] = st[nt][e] * (dpt[nt][e] - ((e & 1) ? d.y : d.x));
    }
    uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
    pack_a<kBQ / 16>(pa, st);
    pack_a<kBQ / 16>(da, dpt);

    // dV += P^T dO and dK += dS^T Q over the kBQ queries, dO and Q MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs_tb_n<D>(&dv[0][0], pa[kk], LQ::mnmajor(o_base, kk));
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk)
      wgmma_rs_tb_n<D>(&dk[0][0], da[kk], LQ::mnmajor(q_base, kk));
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();     // K and V are free for staging

  store_rows<D, DR>(dk, a.scale, sK, a.dk + b * a.st[6][0] + kh * a.st[6][2], a.st[6][1], k0,
                    a.Sk, warp, lane);
  store_rows<D, DR>(dv, 1.f, sV, a.dv + b * a.st[7][0] + kh * a.st[7][2], a.st[7][1], k0, a.Sk,
                    warp, lane);
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (b, query head, 64 queries)
// ---------------------------------------------------------------------------
template <int D, int DR>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args a) {
  using L = SwTile<D, kRows>;    // Q, dO, K, V
  constexpr int NT = kBK / 8;    // n8 column groups of S (keys)
  constexpr int DT = D / 8;      // n8 column groups of dQ
  constexpr int KS = D / 16;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sQ = align1024(smem_raw);
  __nv_bfloat16* sO = sQ + L::kElems;        // dO
  __nv_bfloat16* sK = sO + L::kElems;        // [2][L]
  __nv_bfloat16* sV = sK + 2 * L::kElems;    // [2][L]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H, kh = h / (a.H / a.KH);
  const int qt = a.causal ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kRows;
  const int off = a.Sk - a.Sq;

  // keys any row of this block may see: [k_lo, k_hi), as in the forward
  const int first_pos = q0 + off;
  const int last_pos = min(q0 + kRows, a.Sq) - 1 + off;
  const int k_hi = a.causal ? min(a.Sk, last_pos + 1) : a.Sk;
  const int k_lo = a.window >= 0 ? max(0, first_pos - a.window + 1) : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  const __nv_bfloat16* kb = a.k + b * a.st[1][0] + kh * a.st[1][2];
  const __nv_bfloat16* vb = a.v + b * a.st[2][0] + kh * a.st[2][2];
  auto load_kv = [&](int tile, int stage) {
    const int t0 = k_lo + tile * kBK;
    load_tile<D, DR, kBK, kThreads>(sK + stage * L::kElems, kb, a.st[1][1], t0, a.Sk, tid);
    load_tile<D, DR, kBK, kThreads>(sV + stage * L::kElems, vb, a.st[2][1], t0, a.Sk, tid);
  };
  if (n_tiles > 0) {   // Q, dO and the first K/V tile: one group
    load_tile<D, DR, kRows, kThreads>(sQ, a.q + b * a.st[0][0] + h * a.st[0][2], a.st[0][1], q0,
                                      a.Sq, tid);
    load_tile<D, DR, kRows, kThreads>(sO, a.dout + b * a.st[4][0] + h * a.st[4][2], a.st[4][1],
                                      q0, a.Sq, tid);
    load_kv(0, 0);
  }
  cp_async_commit();

  // accumulator fragments: warp w holds rows q0 + 16 w + g and + 8, keys
  // 8 nt + 2 t4 and + 1 of every n8 group nt
  const int qa = q0 + warp * 16 + g;
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = qa + 8 * hr;
    lse_r[hr] = qi < a.Sq ? a.lse[(int64_t)bh * a.Sq + qi] : INFINITY;
    del_r[hr] = qi < a.Sq ? a.delta[(int64_t)bh * a.Sq + qi] : 0.f;
  }
  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  const uint32_t q_base = smem_u32(sQ), o_base = smem_u32(sO);
  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_kv(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile `it` (and Q, dO) have landed
    fence_async_smem();
    __syncthreads();
    const uint32_t k_base = smem_u32(sK + stage * L::kElems);
    const uint32_t v_base = smem_u32(sV + stage * L::kElems);

    // S = Q K^T and dP = dO V^T, 64 x 64 each, as two groups
    float s[NT][4], dp[NT][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_m64n64(&s[0][0], L::kmajor(q_base, ks), L::kmajor(k_base, ks), ks > 0);
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_m64n64(&dp[0][0], L::kmajor(o_base, ks), L::kmajor(v_base, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<1>();   // S has landed; dP may still run

    const int t0 = k_lo + it * kBK;
    const bool edge = t0 + kBK > a.Sk || (a.causal && t0 + kBK - 1 > first_pos) ||
                      (a.window >= 0 && t0 <= last_pos - a.window);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        float p = fast_exp2(fmaf(s[nt][e], a.scale_log2, -lse_r[hr]));
        if (edge && !visible(t0 + nt * 8 + 2 * t4 + (e & 1), qa + 8 * hr + off, a.Sk, a.causal,
                             a.window))
          p = 0.f;
        s[nt][e] = p;
      }
    wgmma_wait<0>();   // dP has landed
    // dS = P (dP - delta), then dQ += dS K with K MN-major
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[nt][e] = s[nt][e] * (dp[nt][e] - del_r[e >> 1]);
    uint32_t da[kBK / 16][4];
    pack_a<kBK / 16>(da, dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_tb_n<D>(&dq[0][0], da[kk], L::mnmajor(k_base, kk));
    wgmma_commit();
    wgmma_wait<0>();
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
  __syncthreads();     // Q is free for staging

  store_rows<D, DR>(dq, a.scale, sQ, a.dq + b * a.st[5][0] + h * a.st[5][2], a.st[5][1], q0,
                    a.Sq, warp, lane);
}

template <int D>
constexpr int dkdv_smem() {
  return 1024 + (2 * kRows + 4 * kBQ) * D * 2 + 4 * kBQ * 4;
}
template <int D>
constexpr int dq_smem() {
  return 1024 + (2 * kRows + 4 * kBK) * D * 2;
}

template <int D, int DR>
int launch(const Args& a, float* delta, cudaStream_t st) {
  auto kdkdv = flash_bwd_dkdv_kernel<D, DR>;
  auto kdq = flash_bwd_dq_kernel<D, DR>;
  cudaError_t e = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       dkdv_smem<D>());
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
  if (e != cudaSuccess) return (int)e;

  const int64_t rows = (int64_t)a.B * a.H * a.Sq;
  flash_bwd_delta_kernel<<<(unsigned)((rows + kDeltaRows - 1) / kDeltaRows), kThreads, 0, st>>>(
      a.o, a.dout, delta, a.H, a.Sq, DR, rows, a.st[3][0], a.st[3][1], a.st[3][2],
      a.st[4][0], a.st[4][1], a.st[4][2]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdkdv<<<dim3(a.B * a.KH, (a.Sk + kRows - 1) / kRows), kThreads, dkdv_smem<D>(), st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdq<<<dim3(a.B * a.H, (a.Sq + kRows - 1) / kRows), kThreads, dq_smem<D>(), st>>>(a);
  return (int)cudaGetLastError();
}

template <int D, int DR>
int resources(int* out) {
  const void* fns[3] = {(const void*)flash_bwd_delta_kernel,
                        (const void*)flash_bwd_dkdv_kernel<D, DR>,
                        (const void*)flash_bwd_dq_kernel<D, DR>};
  const int smem[3] = {0, dkdv_smem<D>(), dq_smem<D>()};
  for (int i = 0; i < 3; ++i) {
    cudaFuncAttributes at;
    const cudaError_t e = cudaFuncGetAttributes(&at, fns[i]);
    if (e != cudaSuccess) return (int)e;
    out[2 * i] = at.numRegs;
    out[2 * i + 1] = smem[i] + (int)at.sharedSizeBytes;
  }
  return 0;
}

}  // namespace

extern "C" {
// q/o/dO/dQ: (B, Sq, H, D); k/v/dK/dV: (B, Sk, KH, D); all bf16 with unit
// stride on D and the (batch, seq, head) strides, in elements, in
// `strides[24]` in the order q, k, v, o, dO, dQ, dK, dV. lse: (B, H, Sq)
// f32 from the forward (exp2 domain); delta: (B, H, Sq) f32 scratch.
// window < 0: no window. Launches the delta, dK/dV and dQ kernels in that
// order on `stream`. Returns the first cudaError_t; 1
// (cudaErrorInvalidValue) for a D this file was not compiled for.
int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* delta, void* dq, void* dk,
                   void* dv, int B, int H, int KH, int Sq, int Sk, int D,
                   const int64_t* strides, float scale, int causal, int window,
                   void* stream) {
  if (D != 32 && D != 64 && D != 120 && D != 128) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Sq == 0 || Sk == 0) return (int)cudaGetLastError();
  Args a;
  a.q = (const __nv_bfloat16*)q;
  a.k = (const __nv_bfloat16*)k;
  a.v = (const __nv_bfloat16*)v;
  a.o = (const __nv_bfloat16*)o;
  a.dout = (const __nv_bfloat16*)dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = (__nv_bfloat16*)dq;
  a.dk = (__nv_bfloat16*)dk;
  a.dv = (__nv_bfloat16*)dv;
  a.B = B;
  a.H = H;
  a.KH = KH;
  a.Sq = Sq;
  a.Sk = Sk;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) a.st[t][i] = strides[3 * t + i];
  a.scale = scale;
  a.scale_log2 = scale * 1.4426950408889634f;
  a.causal = causal;
  a.window = window;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32, 32>(a, delta, st);
    case 64: return launch<64, 64>(a, delta, st);
    case 120: return launch<128, 120>(a, delta, st);
    default: return launch<128, 128>(a, delta, st);
  }
}

// Registers per thread and shared memory per block (dynamic + static, in
// bytes) of the delta, dK/dV and dQ kernels at head dim D, into out[6] as
// (registers, shared) pairs in that order. Returns a cudaError_t.
int flash_bwd_resources(int D, int* out) {
  switch (D) {
    case 32: return resources<32, 32>(out);
    case 64: return resources<64, 64>(out);
    case 120: return resources<128, 120>(out);
    case 128: return resources<128, 128>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
}
