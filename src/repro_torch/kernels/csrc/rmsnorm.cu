// RMSNorm over the rows of a (R, d) matrix: y = x * rsqrt(mean(x^2) + eps) * w,
// computed in f32 and cast back to x's type.
//
// Replaces the Pallas kernel `_rmsnorm_kernel` (src/repro/kernels/rmsnorm.py).
// Bound on an H100: bytes. Per element it reads x, writes y and does four
// f32 operations, three orders of magnitude below the card's ratio of
// operations to bytes. Design: one block per row, so the reduction needs no
// second pass across blocks; 16-byte vector loads and stores where the row
// width and the pointers allow them; a warp-shuffle reduction then one across
// the block's warps. The second pass re-reads the row, which a block has just
// read, from L1/L2 instead of device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// VEC: elements of T in 16 bytes; vectorized is set by the host when d is a
// multiple of VEC and x, y are 16-byte aligned.
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
               int d, float eps, int vectorized) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[kThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
  if (vectorized) {
    const int nv = d / VEC;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float f = to_f(e[j]);
        ss += f * f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      float f = to_f(xr[i]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / (float)d + eps);

  if (vectorized) {
    const int nv = d / VEC;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o[j] = from_f<T>(to_f(e[j]) * r * to_f(w[i * VEC + j]));
      reinterpret_cast<uint4*>(yr)[i] = out;
    }
  } else {
    for (int i = threadIdx.x; i < d; i += blockDim.x)
      yr[i] = from_f<T>(to_f(xr[i]) * r * to_f(w[i]));
  }
}

template <typename T, typename W>
int launch(const void* x, const void* w, void* y, int64_t rows, int d, float eps,
           int vectorized, void* stream) {
  if (rows > 0) {
    rmsnorm_kernel<T, W><<<(unsigned)rows, kThreads, 0, (cudaStream_t)stream>>>(
        (const T*)x, (const W*)w, (T*)y, d, eps, vectorized);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {
// x, y: (rows, d) row-major; w: (d,). Returns the cudaError_t of the launch.
int rmsnorm_bf16_wbf16(const void* x, const void* w, void* y, int64_t rows, int d,
                       float eps, int vectorized, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, vectorized, stream);
}
int rmsnorm_bf16_wf32(const void* x, const void* w, void* y, int64_t rows, int d,
                      float eps, int vectorized, void* stream) {
  return launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, vectorized, stream);
}
int rmsnorm_f32_wbf16(const void* x, const void* w, void* y, int64_t rows, int d,
                      float eps, int vectorized, void* stream) {
  return launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, vectorized, stream);
}
int rmsnorm_f32_wf32(const void* x, const void* w, void* y, int64_t rows, int d,
                     float eps, int vectorized, void* stream) {
  return launch<float, float>(x, w, y, rows, d, eps, vectorized, stream);
}
}
