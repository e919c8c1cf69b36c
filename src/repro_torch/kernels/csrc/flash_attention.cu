// Forward attention with an online softmax on the tensor cores: causal
// masks, sliding windows, queries aligned to the end of the keys (offset
// Sk - Sq), and grouped-query attention by indexing (query head h reads KV
// head h / group; K and V are never expanded per query head).
//
// Replaces the Pallas kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py). The TPU kernel walks the key blocks
// as its sequential grid dimension and carries the running max, sum and
// accumulator in VMEM scratch; here one thread block owns a (batch*head,
// 64-query tile) and walks the key tiles in a loop, with the running
// statistics in registers.
//
// Bound on an H100 at the prefill shapes: operations, 4 * D flops per valid
// (query, key) pair on the bf16 tensor cores (989 TFLOP/s dense) against
// 2 bytes per element of q, k, v and o. The design:
//
// - One warpgroup (4 warps, 128 threads) per block, 64 query rows: both
//   products are warpgroup MMAs (`wgmma.mma_async`, sm_90a), bf16 operands
//   with f32 accumulators. S = Q K^T is m64n64k16 with Q and K read from
//   shared memory through matrix descriptors (both K-major, as they lie in
//   memory); O += P V is m64nDk16 with P fed from registers as the A operand
//   and V read from shared memory MN-major (the instruction transposes it),
//   so nothing is transposed in memory.
// - P is rounded to bf16 before the second product (the tensor cores take
//   bf16 operands); the row sums l are taken from the f32 values.
// - Q is loaded once. K/V tiles of 64 keys go through a two-stage ring in
//   shared memory, filled by 16-byte `cp.async`: the next tile's load is
//   issued before the current tile's products and lands while they run.
//   Every tile is stored in the layout the descriptors name: rows of 128
//   bytes (64-column blocks for D = 128) with the 128-byte swizzle, or of
//   64 bytes with the 64-byte swizzle at D = 32, so the tensor cores read
//   without bank conflicts. The output goes back through the same layout,
//   so every global store is 16 bytes wide.
// - The online softmax runs on the accumulator fragments: the four lanes
//   that share a row reduce its max with two shuffles; exp2 with
//   scale * log2(e) folded in; the row sums stay per lane and are reduced
//   once at the end. Masks are applied only on tiles that cross the causal
//   diagonal, the window's edge or Sk; key tiles wholly past the diagonal
//   or before the window are never loaded. A row with no valid key keeps
//   max -inf, its exponentials are 0, and it writes 0 (the Pallas kernel
//   writes the mean of V there; the JAX package's CPU path writes 0).
// - The grid is (B*H, query tiles) with the heaviest causal tiles first, so
//   the last wave is not a tail of long tiles.
// - Head dim 120 (h2o-danube-3-4b) runs the D = 128 instantiation: the
//   loads zero-fill columns 120..127 in shared memory, which leaves Q K^T
//   unchanged and gives zero output columns, and the store drops them.
// - With a non-null `lse` the kernel also writes each row's log-sum-exp of
//   its scaled logits in the exp2 domain, m * scale * log2(e) + log2(l),
//   from which flash_attention_bwd.cu recomputes P.
//
// Resources (nvcc -Xptxas -v, sm_90a, CUDA 12.8; chip_smoke.py's build phase
// prints them for every build and fails on a spill): 158 registers per
// thread at D = 128, 157 at D = 120, 109 at D = 64, 112 at D = 32, no
// spills. Shared memory per block is dynamic: Q and the two-stage K/V
// ring, 5 * 64 * D * 2 bytes
// plus 1 KiB of alignment, 81 KiB at D = 128, so two blocks share an SM
// (registers would allow three). The products wait for each other (no
// second warpgroup or producer warp overlaps the softmax with the MMAs);
// that and the 64-row tile, which leaves SMs idle for short prompts with
// few heads, are what is left between this kernel and the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBQ = 64;        // query rows per block: one wgmma M tile
constexpr int kBK = 64;        // keys per shared-memory tile
constexpr int kThreads = 128;  // one warpgroup

// Q, K, V and O tiles of 64 rows in the swizzled layout of hopper.cuh
template <int D>
using Tile = SwTile<D, 64>;

template <int D, int DR>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int H, int group, int Sq, int Sk,
                       int64_t q_sb, int64_t q_ss, int64_t q_sh,
                       int64_t k_sb, int64_t k_ss, int64_t k_sh,
                       int64_t v_sb, int64_t v_ss, int64_t v_sh,
                       int64_t o_sb, int64_t o_ss, int64_t o_sh,
                       float scale_log2, int causal, int window) {
  constexpr int CH = D / 8;        // 16-byte chunks per stored row
  constexpr int CHR = DR / 8;      // of which hold the head dim
  constexpr int KS = D / 16;       // k16 steps of Q K^T
  constexpr int NT = kBK / 8;      // n8 column groups of S
  constexpr int DT = D / 8;        // n8 column groups of O
  using L = Tile<D>;
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* sK = sQ + L::kElems;        // [2][Tile]
  __nv_bfloat16* sV = sK + 2 * L::kElems;    // [2][Tile]
  __nv_bfloat16* sO = sK;                    // K stage 0, after the loop

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H, kh = h / group;
  const int qt = causal ? (int)gridDim.y - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int off = Sk - Sq;

  // keys any row of this block may see: [k_lo, k_hi)
  const int first_pos = q0 + off;
  const int last_pos = min(q0 + kBQ, Sq) - 1 + off;
  const int k_hi = causal ? min(Sk, last_pos + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, first_pos - window + 1) : 0;
  const int t_begin = (k_lo / kBK) * kBK;
  const int n_tiles = k_hi > t_begin ? (k_hi - t_begin + kBK - 1) / kBK : 0;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
  if (n_tiles == 0) {   // no row of this block sees a key
    for (int idx = tid; idx < kBQ * CHR; idx += kThreads) {
      const int r = idx / CHR, c = idx % CHR;
      if (q0 + r < Sq)
        *reinterpret_cast<uint4*>(ob + (int64_t)(q0 + r) * o_ss + c * 8) = make_uint4(0, 0, 0, 0);
    }
    if (lse != nullptr && tid < kBQ && q0 + tid < Sq) lse[(int64_t)bh * Sq + q0 + tid] = INFINITY;
    return;
  }

  const __nv_bfloat16* kb = k + b * k_sb + kh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kh * v_sh;
  auto load_kv = [&](int tile, int stage) {
    const int t0 = t_begin + tile * kBK;
    load_tile<D, DR, kBK, kThreads>(sK + stage * L::kElems, kb, k_ss, t0, Sk, tid);
    load_tile<D, DR, kBK, kThreads>(sV + stage * L::kElems, vb, v_ss, t0, Sk, tid);
  };
  load_tile<D, DR, kBQ, kThreads>(sQ, qb, q_ss, q0, Sq, tid);   // Q and tile 0: one group
  load_kv(0, 0);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  // accumulator fragments: warp w holds rows 16 w + g and 16 w + g + 8,
  // columns 8 j + 2 t4 and + 1 of every n8 group j
  const int g = lane >> 2, t4 = lane & 3;
  const int qpos0 = q0 + warp * 16 + g + off;
  const uint32_t q_base = smem_u32(sQ);

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) load_kv(it + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile `it` (and Q) have landed
    fence_async_smem();
    __syncthreads();
    const uint32_t k_base = smem_u32(sK + stage * L::kElems);
    const uint32_t v_base = smem_u32(sV + stage * L::kElems);

    // S = Q K^T, 64 x 64 over the warpgroup
    float s[NT][4];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_ss_m64n64(&s[0][0], L::kmajor(q_base, ks), L::kmajor(k_base, ks), ks > 0);
    wgmma_commit();
    wgmma_wait_all();

    const int t0 = t_begin + it * kBK;
    const bool edge = t0 + kBK > Sk || (causal && t0 + kBK - 1 > first_pos) ||
                      (window >= 0 && t0 <= last_pos - window);
    if (edge) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = t0 + nt * 8 + t4 * 2 + (e & 1);
          const int qp = qpos0 + (e >> 1) * 8;
          const bool ok = kp < Sk && (!causal || kp <= qp) && (window < 0 || kp > qp - window);
          if (!ok) s[nt][e] = -INFINITY;
        }
    }

    // online softmax on the fragments; row hr of this lane is qpos0 + 8 * hr
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[hr], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;   // a row with no key yet
      const float alpha = fast_exp2((m_run[hr] - m_use) * scale_log2);
      const float mb = m_use * scale_log2;
      float rs = 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(fmaf(s[nt][2 * hr + e], scale_log2, -mb));
          s[nt][2 * hr + e] = p;
          rs += p;
        }
      l_run[hr] = l_run[hr] * alpha + rs;
      m_run[hr] = m_new;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * hr] *= alpha;
        acc[dt][2 * hr + 1] *= alpha;
      }
    }

    // O += P V, P from the score fragments rounded to bf16
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs_tb_n<D>(&acc[0][0], pa[kk], L::mnmajor(v_base, kk));
    wgmma_commit();
    wgmma_wait_all();
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

  // normalise, stage this warp's 16 rows through K stage 0, store 16 bytes wide
  float inv[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = l_run[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[hr] = l > 0.f ? 1.f / l : 0.f;
    // log-sum-exp of the row's scaled logits in the exp2 domain, for the
    // backward: p = exp2(s * scale_log2 - lse); +inf for a row with no key
    const int row = q0 + warp * 16 + g + 8 * hr;
    if (lse != nullptr && t4 == 0 && row < Sq)
      lse[(int64_t)bh * Sq + row] = l > 0.f ? fmaf(m_run[hr], scale_log2, log2f(l)) : INFINITY;
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<__nv_bfloat162*>(sO + L::off(warp * 16 + g + 8 * hr, dt) + t4 * 2) =
          __floats2bfloat162_rn(acc[dt][2 * hr] * inv[hr], acc[dt][2 * hr + 1] * inv[hr]);
  __syncwarp();
  {
    constexpr int RS = 32 / CH;
    const int c = lane % CH, r0 = lane / CH;
    __nv_bfloat16* p = ob + (int64_t)(q0 + warp * 16 + r0) * o_ss + c * 8;
#pragma unroll
    for (int i = 0; i < 16 / RS; ++i) {
      const int r = warp * 16 + r0 + i * RS;
      if (q0 + r < Sq && c < CHR)
        *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(sO + L::off(r, c));
      p += RS * o_ss;
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, KH, Sq, Sk;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale;
  int causal, window;
};

template <int D, int DR>
int launch(const Args& a, cudaStream_t st) {
  const int smem = 5 * Tile<D>::kElems * (int)sizeof(__nv_bfloat16) + 1024;
  auto kern = flash_fwd_wgmma_kernel<D, DR>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.B * a.H, (a.Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, st>>>(
      (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k, (const __nv_bfloat16*)a.v,
      (__nv_bfloat16*)a.o, a.lse, a.H, a.H / a.KH, a.Sq, a.Sk, a.q_sb, a.q_ss, a.q_sh, a.k_sb,
      a.k_ss, a.k_sh, a.v_sb, a.v_ss, a.v_sh, a.o_sb, a.o_ss, a.o_sh,
      a.scale * 1.4426950408889634f, a.causal, a.window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {
// q: (B, Sq, H, D), k/v: (B, Sk, KH, D), o: (B, Sq, H, D), all bf16 with unit
// stride on D; the other strides are in elements. window < 0: no window.
// lse: null, or (B, H, Sq) f32, contiguous: each row's log-sum-exp in the
// exp2 domain (+inf for a row with no valid key), saved for the backward.
// D = 120 runs the D = 128 tiles with the last 8 columns zero in shared
// memory. Returns the cudaError_t of the launch; 1 (cudaErrorInvalidValue)
// for a D this file was not compiled for.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int H, int KH, int Sq, int Sk, int D,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   int64_t o_sb, int64_t o_ss, int64_t o_sh,
                   float scale, int causal, int window, void* stream) {
  if (D != 32 && D != 64 && D != 120 && D != 128) return (int)cudaErrorInvalidValue;
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  const Args a{q, k, v, o, lse, B, H, KH, Sq, Sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
               v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal, window};
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch<32, 32>(a, st);
    case 64: return launch<64, 64>(a, st);
    case 120: return launch<128, 120>(a, st);
    default: return launch<128, 128>(a, st);
  }
}
}
