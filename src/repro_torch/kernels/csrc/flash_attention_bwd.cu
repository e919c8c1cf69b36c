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
// 1. delta: D_i = sum_d dO_id * O_id in f32, one warp per query row.
// 2. dK/dV: one block per (batch, KV head, 64-key tile). It loops over every
//    query head of the GQA group and over the query tiles that can see its
//    keys, and keeps dK and dV of its 64 keys in registers, so they are
//    summed over the group with no atomics and the same bits on every run:
//      S^T = K Q^T, P^T = exp2(S^T c - lse), dV += P^T dO,
//      dP^T = V dO^T, dS^T = P^T (dP^T - D), dK += dS^T Q.
// 3. dQ: one block per (batch, query head, 64-query tile), looping over the
//    key tiles the tile can see: S = Q K^T, dP = dO V^T, dS = P (dP - D),
//    dQ += dS K.
// dK and dQ are scaled by the softmax scale at the store.
//
// Bound on an H100: operations. Five products of 2 * D flops per valid
// (query, key) pair (S and dP recomputed in both kernels, then dV, dK and
// dQ) on the bf16 tensor cores, 2.5 times the forward's two. This first
// version is simple: 4 warps per block, each owning 16 rows, warp-level
// `mma.sync` m16n8k16 (bf16 operands, f32 accumulators) with operands from
// shared memory through `ldmatrix`, rows padded by 16 bytes against bank
// conflicts, tiles loaded with 16-byte `cp.async` and no double buffering.
// P and dS are rounded to bf16 before the products that take them, as the
// forward rounds P. Head dim 120 runs the 128 tiles with zero columns.
// `wgmma`, TMA and a pipelined ring are later work.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8): dK/dV 238 registers per
// thread at D = 128 (32 queries a step), 177 at D = 64, 148 at D = 32; dQ
// 166, 158, 126; no spills. Shared memory: 51 KiB (dK/dV) and 68 KiB (dQ)
// at D = 128. On an H100 the three launches take about 10 % of the bound
// at qwen1.5-0.5b's training shape (PERF.md): every product waits for its
// operands' loads and for the other warps at each tile's barrier.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 128;   // 4 warps, 16 rows each
constexpr int kRows = 64;       // rows per block: keys (dK/dV) or queries (dQ)
constexpr int kKeyTile = 64;    // keys per inner step of the dQ kernel

// queries per inner step of the dK/dV kernel: at D = 128 the dK and dV
// accumulators take 128 registers a thread, so the score tiles stay small
template <int D>
struct BwdTiles {
  static constexpr int kQ = D >= 128 ? 32 : 64;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory address of the lane's row for an ldmatrix.x4 that reads a
// 16 x 16 block at (r0, c0) of a row-major tile with row stride S elements:
// as an A fragment (non-transposed), or as the B fragments of two n8 tiles
// of a [k][n] tile (transposed).
template <int S>
__device__ __forceinline__ uint32_t frag_a(const __nv_bfloat16* t, int r0, int c0, int lane) {
  return smem_u32(t + (r0 + (lane & 15)) * S + c0 + (lane >> 4) * 8);
}
// ... the B fragments of two n8 tiles (n0, n0 + 8) over k0 .. k0 + 15 of an
// [n][k] tile (non-transposed)
template <int S>
__device__ __forceinline__ uint32_t frag_b_nk(const __nv_bfloat16* t, int n0, int k0, int lane) {
  return smem_u32(t + (n0 + (lane & 7) + (lane >> 4) * 8) * S + k0 + ((lane >> 3) & 1) * 8);
}

// cp.async of ROWS rows of DR bf16 into a tile of width D (row stride D + 8
// elements): global rows row0 + r, rows at or past `limit` and columns DR ..
// D - 1 zero-filled.
template <int D, int DR, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t ss, int row0, int limit, int tid) {
  constexpr int CH = D / 8, S = D + 8;
#pragma unroll 4
  for (int idx = tid; idx < ROWS * CH; idx += kThreads) {
    const int r = idx / CH, c = idx - r * CH;
    const bool ok = c < DR / 8 && row0 + r < limit;
    const __nv_bfloat16* p = ok ? src + (int64_t)(row0 + r) * ss + c * 8 : src;
    cp_async16(smem_u32(dst + r * S + c * 8), p, ok);
  }
}

__device__ __forceinline__ bool visible(int kp, int qp, int Sk, int causal, int window) {
  return kp < Sk && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O), one warp per (b, h, query) row
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                       float* __restrict__ delta, int H, int Sq, int D, int64_t rows,
                       int64_t o_sb, int64_t o_ss, int64_t o_sh,
                       int64_t d_sb, int64_t d_ss, int64_t d_sh) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int64_t bh = row / Sq;
  const int s = (int)(row - bh * Sq);
  const int b = (int)(bh / H), h = (int)(bh - (int64_t)b * H);
  const __nv_bfloat16* op = o + b * o_sb + (int64_t)s * o_ss + h * o_sh;
  const __nv_bfloat16* dp = dout + b * d_sb + (int64_t)s * d_ss + h * d_sh;
  float acc = 0.f;
  for (int d = lane * 2; d < D; d += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + d));
    const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dp + d));
    acc = fmaf(a.x, c.x, fmaf(a.y, c.y, acc));
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) delta[row] = acc;
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
  constexpr int S = D + 8;              // padded shared-memory row
  constexpr int BQ = BwdTiles<D>::kQ;   // queries per inner step
  constexpr int NQ = BQ / 8;            // n8 tiles of S^T over queries
  constexpr int ND = D / 8;             // n8 tiles over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kRows * S;
  __nv_bfloat16* sQ = sV + kRows * S;
  __nv_bfloat16* sO = sQ + BQ * S;      // dO tile
  float* sL = reinterpret_cast<float*>(sO + BQ * S);
  float* sD = sL + BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int bkh = blockIdx.x;
  const int b = bkh / a.KH, kh = bkh - b * a.KH;
  const int group = a.H / a.KH;
  const int k0 = blockIdx.y * kRows;
  const int off = a.Sk - a.Sq;

  const __nv_bfloat16* kb = a.k + b * a.st[1][0] + kh * a.st[1][2];
  const __nv_bfloat16* vb = a.v + b * a.st[2][0] + kh * a.st[2][2];
  load_rows<D, DR, kRows>(sK, kb, a.st[1][1], k0, a.Sk, tid);
  load_rows<D, DR, kRows>(sV, vb, a.st[2][1], k0, a.Sk, tid);
  cp_async_commit();

  // queries that may see a key of this tile: [q_lo, q_hi)
  const int k_last = min(k0 + kRows, a.Sk) - 1;
  int q_lo = a.causal ? k0 - off : 0;
  int q_hi = a.window >= 0 ? k_last + a.window - off : a.Sq;
  q_lo = max(q_lo, 0);
  q_hi = min(q_hi, a.Sq);
  const int qt_begin = (q_lo / BQ) * BQ;

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  const int kp0 = k0 + warp * 16 + g;   // this lane's keys: kp0 and kp0 + 8
  for (int j = 0; j < group && q_lo < q_hi; ++j) {
    const int h = kh * group + j;
    const int64_t bh = (int64_t)b * a.H + h;
    const __nv_bfloat16* qb = a.q + b * a.st[0][0] + h * a.st[0][2];
    const __nv_bfloat16* ob = a.dout + b * a.st[4][0] + h * a.st[4][2];
    for (int q0 = qt_begin; q0 < q_hi; q0 += BQ) {
      __syncthreads();   // every warp is done with the previous Q / dO tile
      load_rows<D, DR, BQ>(sQ, qb, a.st[0][1], q0, a.Sq, tid);
      load_rows<D, DR, BQ>(sO, ob, a.st[4][1], q0, a.Sq, tid);
      cp_async_commit();
      for (int i = tid; i < BQ; i += kThreads) {
        const bool in = q0 + i < a.Sq;
        sL[i] = in ? a.lse[bh * a.Sq + q0 + i] : INFINITY;
        sD[i] = in ? a.delta[bh * a.Sq + q0 + i] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ queries per warp
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, frag_a<S>(sK, warp * 16, ks * 16, lane));
        ldsm_x4(av, frag_a<S>(sV, warp * 16, ks * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bq[4], bo[4];
          ldsm_x4(bq, frag_b_nk<S>(sQ, np * 16, ks * 16, lane));
          ldsm_x4(bo, frag_b_nk<S>(sO, np * 16, ks * 16, lane));
          mma16816(st[2 * np], ak, bq[0], bq[1]);
          mma16816(st[2 * np + 1], ak, bq[2], bq[3]);
          mma16816(dpt[2 * np], av, bo[0], bo[1]);
          mma16816(dpt[2 * np + 1], av, bo[2], bo[3]);
        }
      }
      // P^T and dS^T; element e of tile nt: key kp0 + 8 (e >> 1), query
      // q0 + 8 nt + 2 t4 + (e & 1)
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = nt * 8 + 2 * t4 + (e & 1);
          const int kp = kp0 + 8 * (e >> 1);
          const bool ok = q0 + qi < a.Sq && visible(kp, q0 + qi + off, a.Sk, a.causal, a.window);
          const float p = ok ? fast_exp2(fmaf(st[nt][e], a.scale_log2, -sL[qi])) : 0.f;
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - sD[qi]);
        }
      // dV += P^T dO and dK += dS^T Q, over the BQ queries in k16 steps
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t ap[4], ad[4];
        ap[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        ap[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        ap[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        ap[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        ad[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        ad[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        ad[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        ad[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t bo[4], bq[4];
          ldsm_x4_t(bo, frag_a<S>(sO, kk * 16, dp * 16, lane));
          ldsm_x4_t(bq, frag_a<S>(sQ, kk * 16, dp * 16, lane));
          mma16816(dv[2 * dp], ap, bo[0], bo[1]);
          mma16816(dv[2 * dp + 1], ap, bo[2], bo[3]);
          mma16816(dk[2 * dp], ad, bq[0], bq[1]);
          mma16816(dk[2 * dp + 1], ad, bq[2], bq[3]);
        }
      }
    }
  }
  cp_async_wait<0>();   // a block whose keys no query sees still drains its loads

  // store: element e of tile dt is key kp0 + 8 (e >> 1), column 8 dt + 2 t4
  __nv_bfloat16* dkb = a.dk + b * a.st[6][0] + kh * a.st[6][2];
  __nv_bfloat16* dvb = a.dv + b * a.st[7][0] + kh * a.st[7][2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kp = kp0 + 8 * hr;
    if (kp >= a.Sk) continue;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      const int c = dt * 8 + 2 * t4;
      if (c >= DR) continue;
      *reinterpret_cast<__nv_bfloat162*>(dkb + (int64_t)kp * a.st[6][1] + c) =
          __floats2bfloat162_rn(dk[dt][2 * hr] * a.scale, dk[dt][2 * hr + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (int64_t)kp * a.st[7][1] + c) =
          __floats2bfloat162_rn(dv[dt][2 * hr], dv[dt][2 * hr + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block per (b, query head, 64 queries)
// ---------------------------------------------------------------------------
template <int D, int DR>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const Args a) {
  constexpr int S = D + 8;
  constexpr int NK = kKeyTile / 8;     // n8 tiles of S over keys
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sO = sQ + kRows * S;   // dO tile
  __nv_bfloat16* sK = sO + kRows * S;
  __nv_bfloat16* sV = sK + kKeyTile * S;

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
  const int t_begin = (k_lo / kKeyTile) * kKeyTile;

  load_rows<D, DR, kRows>(sQ, a.q + b * a.st[0][0] + h * a.st[0][2], a.st[0][1], q0, a.Sq, tid);
  load_rows<D, DR, kRows>(sO, a.dout + b * a.st[4][0] + h * a.st[4][2], a.st[4][1], q0, a.Sq,
                          tid);
  cp_async_commit();

  const int qa = q0 + warp * 16 + g;    // this lane's rows: qa and qa + 8
  float lse_r[2], del_r[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = qa + 8 * hr;
    lse_r[hr] = qi < a.Sq ? a.lse[(int64_t)bh * a.Sq + qi] : INFINITY;
    del_r[hr] = qi < a.Sq ? a.delta[(int64_t)bh * a.Sq + qi] : 0.f;
  }
  float dq[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  const __nv_bfloat16* kb = a.k + b * a.st[1][0] + kh * a.st[1][2];
  const __nv_bfloat16* vb = a.v + b * a.st[2][0] + kh * a.st[2][2];
  for (int t0 = t_begin; t0 < k_hi; t0 += kKeyTile) {
    __syncthreads();   // every warp is done with the previous K / V tile
    load_rows<D, DR, kKeyTile>(sK, kb, a.st[1][1], t0, a.Sk, tid);
    load_rows<D, DR, kKeyTile>(sV, vb, a.st[2][1], t0, a.Sk, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int i = 0; i < NK; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, frag_a<S>(sQ, warp * 16, ks * 16, lane));
      ldsm_x4(ao, frag_a<S>(sO, warp * 16, ks * 16, lane));
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, frag_b_nk<S>(sK, np * 16, ks * 16, lane));
        ldsm_x4(bv, frag_b_nk<S>(sV, np * 16, ks * 16, lane));
        mma16816(s[2 * np], aq, bk[0], bk[1]);
        mma16816(s[2 * np + 1], aq, bk[2], bk[3]);
        mma16816(dp[2 * np], ao, bv[0], bv[1]);
        mma16816(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
    // dS = P (dP - delta); element e of tile nt: query qa + 8 (e >> 1), key
    // t0 + 8 nt + 2 t4 + (e & 1)
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hr = e >> 1;
        const int kp = t0 + nt * 8 + 2 * t4 + (e & 1);
        const int qi = qa + 8 * hr;
        const bool ok = qi < a.Sq && visible(kp, qi + off, a.Sk, a.causal, a.window);
        const float p = ok ? fast_exp2(fmaf(s[nt][e], a.scale_log2, -lse_r[hr])) : 0.f;
        dp[nt][e] = p * (dp[nt][e] - del_r[hr]);
      }
    // dQ += dS K over the tile's keys in k16 steps
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      uint32_t ad[4];
      ad[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      ad[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      ad[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      ad[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int dd = 0; dd < ND / 2; ++dd) {
        uint32_t bk[4];
        ldsm_x4_t(bk, frag_a<S>(sK, kk * 16, dd * 16, lane));
        mma16816(dq[2 * dd], ad, bk[0], bk[1]);
        mma16816(dq[2 * dd + 1], ad, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* dqb = a.dq + b * a.st[5][0] + h * a.st[5][2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int qi = qa + 8 * hr;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int dt = 0; dt < ND; ++dt) {
      const int c = dt * 8 + 2 * t4;
      if (c >= DR) continue;
      *reinterpret_cast<__nv_bfloat162*>(dqb + (int64_t)qi * a.st[5][1] + c) =
          __floats2bfloat162_rn(dq[dt][2 * hr] * a.scale, dq[dt][2 * hr + 1] * a.scale);
    }
  }
}

template <int D, int DR>
int launch(const Args& a, float* delta, cudaStream_t st) {
  constexpr int S = D + 8;
  const int smem_kv = (2 * kRows + 2 * BwdTiles<D>::kQ) * S * 2 + 2 * BwdTiles<D>::kQ * 4;
  const int smem_q = (2 * kRows + 2 * kKeyTile) * S * 2;
  auto kdkdv = flash_bwd_dkdv_kernel<D, DR>;
  auto kdq = flash_bwd_dq_kernel<D, DR>;
  cudaError_t e = cudaFuncSetAttribute(kdkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;

  const int64_t rows = (int64_t)a.B * a.H * a.Sq;
  const int per_block = kThreads / 32;
  flash_bwd_delta_kernel<<<(unsigned)((rows + per_block - 1) / per_block), kThreads, 0, st>>>(
      a.o, a.dout, delta, a.H, a.Sq, DR, rows, a.st[3][0], a.st[3][1], a.st[3][2],
      a.st[4][0], a.st[4][1], a.st[4][2]);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdkdv<<<dim3(a.B * a.KH, (a.Sk + kRows - 1) / kRows), kThreads, smem_kv, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdq<<<dim3(a.B * a.H, (a.Sq + kRows - 1) / kRows), kThreads, smem_q, st>>>(a);
  return (int)cudaGetLastError();
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
}
