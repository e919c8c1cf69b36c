// RMSNorm over the rows of a (R, d) matrix: y = x * rsqrt(mean(x^2) + eps) * w,
// computed in f32 and cast back to x's type.
//
// Replaces the Pallas kernel `_rmsnorm_kernel` (src/repro/kernels/rmsnorm.py).
// Bound on an H100: bytes. Per element it reads x, writes y and does four
// f32 operations, three orders of magnitude below the card's ratio of
// operations to bytes, so the design moves each byte once:
//
// - The row path (`rmsnorm_warp_kernel`): one warp per row, the row held in
//   registers, NV 16-byte vectors per lane (12 at d = 3072 bf16), lane-
//   strided so each load instruction of the warp covers 512 contiguous
//   bytes. NV is a template argument, so the loads carry no bounds checks:
//   the path takes rows of exactly 32 * NV vectors, NV one of the cases of
//   `launch`. x is read once (streaming, evict-first) and y written once
//   (likewise). w is read as 16-byte vectors (8-byte for an f32 row with
//   bf16 weights); where they fit in the registers beside the row, they are
//   loaded together with x's, before the reduction, so a row costs one
//   memory round trip. The sum of squares is a warp-shuffle reduction: no
//   shared memory, no __syncthreads (167 registers at d = 3072 bf16, no
//   spills). Four rows per block: R = 1024 fills the card in one wave, and
//   a decode batch of 8 rows spreads over two SMs (measured on the card:
//   one block of 8 warps for 8 rows was slower, see PERF.md).
// - The two-pass path (`rmsnorm_twopass_kernel`, one block per row): rows
//   the row path does not take (another width, d not a multiple of the
//   16-byte vector, or a pointer not 16-byte aligned). It reads the row
//   twice, the second time from L1/L2. The wrapper picks the path from
//   shape and alignment alone.
//
// Both keep the reference's order of operations, (x * r) * w, so the result
// is within one bf16 ulp of the plain version (the sums of squares are taken
// in another order).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;    // two-pass path: threads per row
constexpr int kRowWarps = 4;     // row path: rows (warps) per block

// `path` argument of the entry points
constexpr int kPathScalar = 0;   // two-pass, element loads
constexpr int kPathVector = 1;   // two-pass, 16-byte loads
constexpr int kPathRow = 2;      // one warp per row, row in registers

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The VEC weights that scale x's vector `vi`: VEC * sizeof(W) bytes as
// 16-byte loads (one 8-byte load for an f32 row with bf16 weights).
template <int VEC, typename W>
struct WVec {
  static constexpr int kBytes = VEC * (int)sizeof(W);
  static constexpr int kWords = kBytes >= 16 ? kBytes / 16 : 1;
  uint4 raw[kWords];
  __device__ __forceinline__ void load(const W* __restrict__ w, int vi) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int p = 0; p < kWords; ++p)
        raw[p] = __ldg(reinterpret_cast<const uint4*>(w) + vi * kWords + p);
    } else {
      static_assert(kBytes == 8, "an f32 row vector with bf16 weights");
      const uint2 h = __ldg(reinterpret_cast<const uint2*>(w) + vi);
      raw[0] = make_uint4(h.x, h.y, 0u, 0u);
    }
  }
  __device__ __forceinline__ float operator[](int j) const {
    return to_f(reinterpret_cast<const W*>(raw)[j]);
  }
};

template <typename T, typename W, int NV>
__global__ void __launch_bounds__(kRowWarps * 32)
rmsnorm_warp_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
                    int64_t rows, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int d = 32 * NV * VEC;
  using WV = WVec<VEC, W>;
  // w's vectors are prefetched when row and weights take at most 36 uint4
  constexpr bool kPrefetchW = NV * (1 + WV::kWords) <= 36;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);

  uint4 v[NV];
  WV wv[kPrefetchW ? NV : 1];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    v[i] = __ldcs(xr + i * 32 + lane);
    if constexpr (kPrefetchW) wv[i].load(w, i * 32 + lane);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const T* e = reinterpret_cast<const T*>(&v[i]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f(e[j]);
      ss += f * f;
    }
  }
  const float r = rsqrtf(warp_sum(ss) / (float)d + eps);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    WV wi;
    if constexpr (kPrefetchW) wi = wv[i];
    else wi.load(w, i * 32 + lane);
    const T* e = reinterpret_cast<const T*>(&v[i]);
    uint4 out;
    T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
    for (int j = 0; j < VEC; ++j) oe[j] = from_f<T>(to_f(e[j]) * r * wi[j]);
    __stcs(yr + i * 32 + lane, out);
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

// vectorized: d is a multiple of VEC and x, y are 16-byte aligned.
template <typename T, typename W>
__global__ void __launch_bounds__(kThreads)
rmsnorm_twopass_kernel(const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ y,
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

template <typename T, typename W, int NV>
void launch_rows(const void* x, const void* w, void* y, int64_t rows, float eps,
                 cudaStream_t st) {
  const int64_t blocks = (rows + kRowWarps - 1) / kRowWarps;
  rmsnorm_warp_kernel<T, W, NV><<<(unsigned)blocks, kRowWarps * 32, 0, st>>>(
      (const T*)x, (const W*)w, (T*)y, rows, eps);
}

// Row widths of the row path, in steps of 32 vectors (one per lane): d =
// 1024 ... 6144 for bf16 rows, the widths of the configs; kept in step with
// ROW_STEPS in rmsnorm.py.
template <typename T, typename W>
int launch(const void* x, const void* w, void* y, int64_t rows, int d, float eps,
           int path, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (rows <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (path == kPathRow) {
    if (d % (32 * VEC)) return (int)cudaErrorInvalidValue;
    switch (d / (32 * VEC)) {
      case 4: launch_rows<T, W, 4>(x, w, y, rows, eps, st); break;
      case 6: launch_rows<T, W, 6>(x, w, y, rows, eps, st); break;
      case 8: launch_rows<T, W, 8>(x, w, y, rows, eps, st); break;
      case 12: launch_rows<T, W, 12>(x, w, y, rows, eps, st); break;
      case 16: launch_rows<T, W, 16>(x, w, y, rows, eps, st); break;
      case 20: launch_rows<T, W, 20>(x, w, y, rows, eps, st); break;
      case 24: launch_rows<T, W, 24>(x, w, y, rows, eps, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
  } else if (path == kPathVector || path == kPathScalar) {
    rmsnorm_twopass_kernel<T, W><<<(unsigned)rows, kThreads, 0, st>>>(
        (const T*)x, (const W*)w, (T*)y, d, eps, path == kPathVector);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {
// x, y: (rows, d) row-major; w: (d,). path: 2 row path (d = 32 * NV 16-byte
// vectors, NV one of the cases of `launch`; x, y and w 16-byte aligned), 1
// two-pass with 16-byte loads (d a multiple of the vector; x, y aligned), 0
// two-pass with element loads. Returns the cudaError_t of the launch;
// cudaErrorInvalidValue for a row width the row path was not compiled for.
int rmsnorm_bf16_wbf16(const void* x, const void* w, void* y, int64_t rows, int d,
                       float eps, int path, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, eps, path, stream);
}
int rmsnorm_bf16_wf32(const void* x, const void* w, void* y, int64_t rows, int d,
                      float eps, int path, void* stream) {
  return launch<__nv_bfloat16, float>(x, w, y, rows, d, eps, path, stream);
}
int rmsnorm_f32_wbf16(const void* x, const void* w, void* y, int64_t rows, int d,
                      float eps, int path, void* stream) {
  return launch<float, __nv_bfloat16>(x, w, y, rows, d, eps, path, stream);
}
int rmsnorm_f32_wf32(const void* x, const void* w, void* y, int64_t rows, int d,
                     float eps, int path, void* stream) {
  return launch<float, float>(x, w, y, rows, d, eps, path, stream);
}
}
