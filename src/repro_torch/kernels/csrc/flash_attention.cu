// Forward attention with an online softmax: causal masks, sliding windows,
// queries aligned to the end of the keys (offset Sk - Sq), and grouped-query
// attention by indexing (query head h reads KV head h / group; K and V are
// never expanded per query head).
//
// Replaces the Pallas kernel `_flash_kernel`
// (src/repro/kernels/flash_attention.py). The TPU kernel walks the key blocks
// as its sequential grid dimension and carries the running max, sum and
// accumulator in VMEM scratch; here one thread block owns a (batch*head,
// 64-query tile) and walks the key tiles in a loop, with the running
// statistics in registers.
//
// Bound on an H100 at the prefill shapes: operations (4 * D flops per valid
// (query, key) pair against a few bytes per element of q, k, v and o). This
// first version is simple and right, not fast: the products run on the CUDA
// cores in f32, not on the tensor cores, so it stays far above its bound. Its
// design does two things about the work: key tiles past the causal diagonal
// or before the sliding window are never loaded, and each K/V tile is staged
// once through shared memory for all 64 queries of the block. Four threads
// share a query row, each holding a quarter of the head dim in registers;
// they read 16-byte vectors from shared memory at consecutive addresses, so
// the reads are broadcast without bank conflicts.
//
// Masked scores are -inf and a row with no valid key writes 0 (the Pallas
// kernel writes the mean of V there; the JAX package's CPU path writes 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;    // queries per block
constexpr int kBK = 32;    // keys per shared-memory tile
constexpr int kTPR = 4;    // threads per query row
constexpr int kThreads = kBQ * kTPR;

__device__ __forceinline__ void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 int H, int group, int Sq, int Sk,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh,
                 int64_t k_sb, int64_t k_ss, int64_t k_sh,
                 int64_t v_sb, int64_t v_ss, int64_t v_sh,
                 int64_t o_sb, int64_t o_ss, int64_t o_sh,
                 float scale, int causal, int window) {
  constexpr int VR = D / 8;          // 16-byte vectors in a row of D
  constexpr int NV = VR / kTPR;      // vectors per thread
  constexpr int NE = NV * 8;         // elements per thread
  __shared__ __align__(16) __nv_bfloat16 ks[kBK * D];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK * D];

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - (bh / H) * H, kh = h / group;
  const int tid = threadIdx.x;
  const int row = tid / kTPR, sub = tid - (tid / kTPR) * kTPR;
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + row;
  const bool active = qi < Sq;
  const int off = Sk - Sq;
  const int qpos = qi + off;

  float qr[NE], acc[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) { qr[e] = 0.f; acc[e] = 0.f; }
  if (active) {
    const __nv_bfloat16* qp = q + b * q_sb + (int64_t)qi * q_ss + h * q_sh;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      uint4 raw = *reinterpret_cast<const uint4*>(qp + (sub + kTPR * i) * 8);
      unpack8(raw, qr + 8 * i);
    }
#pragma unroll
    for (int e = 0; e < NE; ++e) qr[e] *= scale;
  }
  float m = -INFINITY, l = 0.f;

  // keys any row of this block may see: [k_lo, k_hi)
  const int first_pos = q0 + off;
  const int last_pos = min(q0 + kBQ, Sq) - 1 + off;
  const int k_hi = causal ? min(Sk, last_pos + 1) : Sk;
  const int k_lo = window >= 0 ? max(0, first_pos - window + 1) : 0;

  const __nv_bfloat16* kb = k + b * k_sb + kh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kh * v_sh;
  for (int t0 = (k_lo / kBK) * kBK; t0 < k_hi; t0 += kBK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kBK * VR; idx += kThreads) {
      const int j = idx / VR, c = idx - (idx / VR) * VR;
      const int kp = t0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (kp < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + (int64_t)kp * k_ss + c * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (int64_t)kp * v_ss + c * 8);
      }
      reinterpret_cast<uint4*>(ks)[idx] = kv;
      reinterpret_cast<uint4*>(vs)[idx] = vv;
    }
    __syncthreads();

    float s[kBK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float kf[8];
        unpack8(reinterpret_cast<const uint4*>(ks)[j * VR + sub + kTPR * i], kf);
#pragma unroll
        for (int e = 0; e < 8; ++e) part += qr[8 * i + e] * kf[e];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = t0 + j;
      const bool valid = kp < Sk && (!causal || kp <= qpos) &&
                         (window < 0 || kp > qpos - window);
      s[j] = valid ? part : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    if (m_new == -INFINITY) continue;  // nothing valid for this row yet
    const float alpha = expf(m - m_new);  // 0 while m is still -inf
    float lsum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);  // masked: exp(-inf) = 0
      lsum += s[j];
    }
    l = l * alpha + lsum;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[e] *= alpha;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float vf[8];
        unpack8(reinterpret_cast<const uint4*>(vs)[j * VR + sub + kTPR * i], vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[8 * i + e] += s[j] * vf[e];
      }
    }
    m = m_new;
  }

  if (active) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* op = o + b * o_sb + (int64_t)qi * o_ss + h * o_sh;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      uint4 out;
      __nv_bfloat162* ho = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int p = 0; p < 4; ++p)
        ho[p] = __floats2bfloat162_rn(acc[8 * i + 2 * p] * inv, acc[8 * i + 2 * p + 1] * inv);
      *reinterpret_cast<uint4*>(op + (sub + kTPR * i) * 8) = out;
    }
  }
}

}  // namespace

extern "C" {
// q: (B, Sq, H, D), k/v: (B, Sk, KH, D), o: (B, Sq, H, D), all bf16 with unit
// stride on D; the other strides are in elements. window < 0: no window.
// Returns the cudaError_t of the launch; 1 (cudaErrorInvalidValue) for a D
// this file was not compiled for.
int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KH, int Sq, int Sk, int D,
                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                   int64_t o_sb, int64_t o_ss, int64_t o_sh,
                   float scale, int causal, int window, void* stream) {
  if (B * H == 0 || Sq == 0) return (int)cudaGetLastError();
  dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  cudaStream_t st = (cudaStream_t)stream;
  const int group = H / KH;
#define FLASH_ARGS                                                                   \
  (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,          \
      (__nv_bfloat16*)o, H, group, Sq, Sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, \
      v_ss, v_sh, o_sb, o_ss, o_sh, scale, causal, window
  switch (D) {
    case 32: flash_fwd_kernel<32><<<grid, kThreads, 0, st>>>(FLASH_ARGS); break;
    case 64: flash_fwd_kernel<64><<<grid, kThreads, 0, st>>>(FLASH_ARGS); break;
    case 128: flash_fwd_kernel<128><<<grid, kThreads, 0, st>>>(FLASH_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
  return (int)cudaGetLastError();
}
}
