// Blockwise absmax int8 quantization of a (R, n) f32 matrix, and its inverse.
//
// Replaces the Pallas kernels `_quant_kernel` and `_dequant_kernel`
// (src/repro/kernels/quant.py). Both are bound on an H100 by bytes: per
// element quant reads 4 bytes and writes 1, dequant reads 1 and writes 2 or 4,
// with a handful of operations each.
//
// quant: one block per (row, quantization block), so a block's absmax needs
// no communication between thread blocks; any block size >= 1 is taken, with
// lanes past the block masked (the ring codec quantizes with
// block = min(256, m)). The arithmetic is the reference's, bit for bit:
// scale = amax / 127 by IEEE division (or 1 when amax is 0),
// q = clip(rint(x / scale), -127, 127) with rint rounding half to even, as
// jnp.round and torch.round do. Build without --use_fast_math.
//
// dequant: elementwise, q * scale of its block, computed in f32 and rounded to
// the output type to nearest even.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// grid: rows * nb blocks, block b of row r is blockIdx.x = r * nb + b.
__global__ void __launch_bounds__(256)
quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
             float* __restrict__ s, int64_t n, int block, int64_t nb) {
  __shared__ float red[8];
  const int64_t rb = blockIdx.x;
  const int64_t row = rb / nb, b = rb - row * nb;
  const int64_t base = row * n + b * (int64_t)block;
  float amax = 0.f;
  for (int i = threadIdx.x; i < block; i += blockDim.x)
    amax = fmaxf(amax, fabsf(x[base + i]));
  amax = block_max(amax, red);
  const float scale = amax > 0.f ? __fdiv_rn(amax, 127.0f) : 1.0f;
  for (int i = threadIdx.x; i < block; i += blockDim.x) {
    float v = rintf(__fdiv_rn(x[base + i], scale));
    v = fminf(fmaxf(v, -127.0f), 127.0f);
    q[base + i] = (int8_t)v;
  }
  if (threadIdx.x == 0) s[rb] = scale;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(256)
dequant_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
               T* __restrict__ out, int64_t total, int64_t n, int block, int64_t nb) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += stride) {
    const int64_t row = i / n, col = i - row * n;
    out[i] = from_f<T>((float)q[i] * s[row * nb + col / block]);
  }
}

unsigned grid_for(int64_t total) {
  int64_t g = (total + 255) / 256;
  const int64_t cap = 132 * 64;  // enough blocks to fill every SM many times
  return (unsigned)(g < cap ? (g > 0 ? g : 1) : cap);
}

template <typename T>
int dequant_launch(const void* q, const void* s, void* out, int64_t rows, int64_t n,
                   int block, void* stream) {
  const int64_t total = rows * n;
  if (total > 0) {
    dequant_kernel<T><<<grid_for(total), 256, 0, (cudaStream_t)stream>>>(
        (const int8_t*)q, (const float*)s, (T*)out, total, n, block, n / block);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {
// x: (rows, n) f32; q: (rows, n) int8; s: (rows, n / block) f32.
int quant_int8_f32(const void* x, void* q, void* s, int64_t rows, int64_t n, int block,
                   void* stream) {
  const int64_t nb = n / block;
  if (rows * nb > 0) {
    int threads = block >= 256 ? 256 : ((block + 31) / 32) * 32;
    quant_kernel<<<(unsigned)(rows * nb), threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int8_t*)q, (float*)s, n, block, nb);
  }
  return (int)cudaGetLastError();
}

int dequant_int8_f32(const void* q, const void* s, void* out, int64_t rows, int64_t n,
                     int block, void* stream) {
  return dequant_launch<float>(q, s, out, rows, n, block, stream);
}

int dequant_int8_bf16(const void* q, const void* s, void* out, int64_t rows, int64_t n,
                      int block, void* stream) {
  return dequant_launch<__nv_bfloat16>(q, s, out, rows, n, block, stream);
}
}
