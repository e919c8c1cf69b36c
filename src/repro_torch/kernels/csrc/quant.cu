// Blockwise absmax int8 quantization of a (R, n) f32 or bf16 matrix, and its
// inverse to f32 or bf16.
//
// Replaces the Pallas kernels `_quant_kernel` and `_dequant_kernel`
// (src/repro/kernels/quant.py). Both are bound on an H100 by bytes: per
// element quant reads 2 (bf16) or 4 (f32) bytes and writes 1, dequant reads 1
// and writes 2 or 4, with a handful of operations each. So each byte is
// moved once, in 16-byte vectors where the shape allows, and the kernels of
// the serving path wait on no block-wide barrier.
//
// The rows are contiguous and n is a multiple of `block`, so quantization
// block b of the flat (R * n) array holds elements [b * block, (b + 1) *
// block) and its scale is s[b]: no kernel splits an element index into
// (row, column).
//
// quant, warp path (`quant_warp_kernel`, block = 256, the block of every
// caller on the serving path, x 16-byte aligned): one warp per quantization
// block, kWarps blocks per thread block. Each lane loads its 8 elements with
// 16-byte loads (one for bf16, two for f32) and keeps them in registers, so
// x is read once; the absmax is a warp shuffle (no shared memory, no
// barrier); the 8 int8 results go out as one 8-byte store and lane 0 writes
// the scale.
// quant, block path (`quant_block_kernel`): any other block size (the ring
// codec's block = min(256, m)) or an x that is not 16-byte aligned. One
// thread block per quantization block, lanes past the block masked, element
// loads, the absmax through shared memory.
// Both take f32 or bf16 x and cast it to f32 in registers, as the TPU kernel
// casts in its body. The arithmetic is the reference's, bit for bit: scale =
// amax / 127 by IEEE division (or 1 when amax is 0), q = clip(rint(x /
// scale), -127, 127) with rint rounding half to even, as jnp.round and
// torch.round do. Build without --use_fast_math. At bf16 the conversion
// unit, not memory, set the pace of a first version (rint and the float to
// int conversion run there at a quarter of the FMA rate, beside the
// division's reciprocal), so the rounding is an add instead: clip first
// (the same, as the bounds are integers), then x + 1.5 * 2^23 rounds to an
// integer half to even and the result's low byte is the int8.
//
// dequant, vector path (`dequant_vec_kernel`, block a multiple of 16, q
// 16-byte aligned): a thread takes 16 int8 with one 16-byte load and loads
// its block's scale once (the index is a shift when the block is a power of
// two). Each int8 becomes an exact f32 by one byte permute into the bits of
// 1.5 * 2^23 + (q + 128) and one subtraction, again off the conversion unit.
// The 32 (bf16) or 64 (f32) bytes of a thread go through shared memory, so
// that each 16-byte store instruction of a warp writes 512 contiguous bytes
// (stored straight from registers, a warp's stores were strided, and f32
// dequant ran at 41 % of its bound).
// dequant, block path (`dequant_block_kernel`): other blocks; one thread
// block per quantization block, the scale loaded once.
// Both compute q * scale in f32 and round it to the output type to nearest
// even, as the reference does.
//
// The wrapper (kernels/quant.py: quant_path, dequant_path) picks the path
// from the block size and the input's address alone; the outputs are fresh
// allocations, aligned to far more than 16 bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // quant warp path: quantization blocks per thread block
constexpr int kWarpBlock = 256;      // quant warp path: the block size, 8 elements a lane
constexpr int kVecThreads = 256;     // dequant vector path: threads per block
constexpr int64_t kMaxGrid = 132 * 64;   // block paths: blocks beyond this loop

// `path` argument of the entry points
constexpr int kPathBlock = 0;
constexpr int kPathVector = 1;       // quant: warp path; dequant: vector path

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float scale_of(float amax) {
  return amax > 0.f ? __fdiv_rn(amax, 127.0f) : 1.0f;
}

constexpr float kRound = 12582912.0f;   // 1.5 * 2^23

// The bits of clip(x / scale, -127, 127) + 1.5 * 2^23, whose low byte is the
// int8 clip(rint(x / scale), -127, 127): the sum lies in [2^23, 2^24), where
// the float spacing is 1, so the add rounds to an integer, half to even (the
// offset is even), and its bits are 0x4B400000 + q.
__device__ __forceinline__ uint32_t quant_bits(float x, float scale) {
  return __float_as_uint(fminf(fmaxf(__fdiv_rn(x, scale), -127.0f), 127.0f) + kRound);
}

// the low bytes of four words, packed
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// 8 consecutive elements as f32, by 16-byte streaming loads (x is read once)
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 r = __ldcs(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {      // element 2k in the low half: exact widening
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
quant_warp_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                  int64_t nblocks) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= nblocks) return;          // the whole warp leaves together
  const int64_t off = b * kWarpBlock + lane * 8;
  float v[8];
  load8(x + off, v);
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) amax = fmaxf(amax, fabsf(v[j]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = scale_of(amax);
  uint32_t u[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) u[j] = quant_bits(v[j], scale);
  *reinterpret_cast<uint2*>(q + off) =
      make_uint2(pack4(u[0], u[1], u[2], u[3]), pack4(u[4], u[5], u[6], u[7]));
  if (lane == 0) s[b] = scale;
}

// max over the thread block; blockDim.x is a multiple of 32, at most 256
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();                   // red is free for the next block
  return v;
}

template <typename T>
__global__ void __launch_bounds__(256)
quant_block_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ s,
                   int block, int64_t nblocks) {
  __shared__ float red[8];
  for (int64_t b = blockIdx.x; b < nblocks; b += gridDim.x) {
    const T* xb = x + b * block;
    int8_t* qb = q + b * block;
    float amax = 0.f;
    for (int i = threadIdx.x; i < block; i += blockDim.x) amax = fmaxf(amax, fabsf(to_f(xb[i])));
    const float scale = scale_of(block_max(amax, red));
    for (int i = threadIdx.x; i < block; i += blockDim.x)
      qb[i] = (int8_t)(quant_bits(to_f(xb[i]), scale) & 0xff);
    if (threadIdx.x == 0) s[b] = scale;
  }
}

// int8 byte j of w as an exact f32: the byte biased by 128 (w ^ 0x80808080)
// under the bits of 1.5 * 2^23, by one permute, less 1.5 * 2^23 + 128
__device__ __forceinline__ float int8_at(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B400000u, 0x7650 | j)) -
         (kRound + 128.0f);
}

// the 16 values of a thread as 16-byte words: 4 of f32, 2 of bf16 (each pair
// rounded to nearest even)
__device__ __forceinline__ void to_words(const float (&f)[16], uint4 (&o)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o[k] = make_uint4(__float_as_uint(f[4 * k]), __float_as_uint(f[4 * k + 1]),
                      __float_as_uint(f[4 * k + 2]), __float_as_uint(f[4 * k + 3]));
}

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void to_words(const float (&f)[16], uint4 (&o)[2]) {
#pragma unroll
  for (int k = 0; k < 2; ++k)
    o[k] = make_uint4(bf16x2(f[8 * k], f[8 * k + 1]), bf16x2(f[8 * k + 2], f[8 * k + 3]),
                      bf16x2(f[8 * k + 4], f[8 * k + 5]), bf16x2(f[8 * k + 6], f[8 * k + 7]));
}

template <int NW>
__device__ __forceinline__ int swz(int t) { return (t / (8 / NW)) % NW; }

// Vector v holds elements [16 v, 16 v + 16), all of quantization block
// v / vpb (= v >> shift when vpb is a power of two, else shift is -1). A
// thread's NW 16-byte words go to shared memory and come back so that store
// j of lane l writes word 32 j + l of its warp's output. Word k of lane t
// sits at NW t + (k ^ swz<NW>(t)): every quarter-warp phase of the 16-byte
// accesses, writing or reading, then touches 8 distinct bank groups.
template <typename T>
__global__ void __launch_bounds__(kVecThreads)
dequant_vec_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                   T* __restrict__ out, int64_t nvec, int64_t vpb, int shift) {
  constexpr int NW = (int)sizeof(T);           // 16-byte words per thread
  __shared__ uint4 buf[kVecThreads / 32][32 * NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t v0 = ((int64_t)blockIdx.x * kVecThreads / 32 + warp) * 32;  // the warp's first
  if (v0 >= nvec) return;            // the whole warp leaves together
  const int64_t v = v0 + lane;
  if (v < nvec) {
    const float scale = __ldg(s + (shift >= 0 ? v >> shift : v / vpb));
    const uint4 r = __ldcs(reinterpret_cast<const uint4*>(q) + v);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    float f[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) f[j] = int8_at(w[j >> 2], j & 3) * scale;
    uint4 o[NW];
    to_words(f, o);
#pragma unroll
    for (int k = 0; k < NW; ++k) buf[warp][NW * lane + (k ^ swz<NW>(lane))] = o[k];
  }
  __syncwarp();
  uint4* dst = reinterpret_cast<uint4*>(out + v0 * 16);
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const int m = 32 * j + lane, t = m / NW, k = m % NW;
    if (v0 + t < nvec) dst[m] = buf[warp][NW * t + (k ^ swz<NW>(t))];
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
dequant_block_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                     T* __restrict__ out, int block, int64_t nblocks) {
  for (int64_t b = blockIdx.x; b < nblocks; b += gridDim.x) {
    const float scale = s[b];
    for (int i = threadIdx.x; i < block; i += blockDim.x)
      out[b * block + i] = from_f<T>((float)q[b * block + i] * scale);
  }
}

unsigned block_grid(int64_t nblocks) {
  return (unsigned)(nblocks < kMaxGrid ? nblocks : kMaxGrid);
}

int block_threads(int block) {
  return block >= 256 ? 256 : ((block + 31) / 32) * 32;
}

template <typename T>
int quant_launch(const void* x, void* q, void* s, int64_t rows, int64_t n, int block,
                 int path, void* stream) {
  if (block < 1 || n % block) return (int)cudaErrorInvalidValue;
  const int64_t nblocks = rows * (n / block);
  const cudaStream_t st = (cudaStream_t)stream;
  if (nblocks <= 0) return (int)cudaGetLastError();
  if (path == kPathVector) {
    const int64_t grid = (nblocks + kWarps - 1) / kWarps;
    if (block != kWarpBlock || grid > INT_MAX) return (int)cudaErrorInvalidValue;
    quant_warp_kernel<T><<<(unsigned)grid, kWarps * 32, 0, st>>>(
        (const T*)x, (int8_t*)q, (float*)s, nblocks);
  } else if (path == kPathBlock) {
    quant_block_kernel<T><<<block_grid(nblocks), block_threads(block), 0, st>>>(
        (const T*)x, (int8_t*)q, (float*)s, block, nblocks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dequant_launch(const void* q, const void* s, void* out, int64_t rows, int64_t n,
                   int block, int path, void* stream) {
  if (block < 1 || n % block) return (int)cudaErrorInvalidValue;
  const int64_t nblocks = rows * (n / block);
  const cudaStream_t st = (cudaStream_t)stream;
  if (nblocks <= 0) return (int)cudaGetLastError();
  if (path == kPathVector) {
    const int64_t nvec = rows * n / 16, vpb = block / 16;
    const int64_t grid = (nvec + kVecThreads - 1) / kVecThreads;
    if (block % 16 || grid > INT_MAX) return (int)cudaErrorInvalidValue;
    const int shift = (vpb & (vpb - 1)) == 0 ? __builtin_ctzll((unsigned long long)vpb) : -1;
    dequant_vec_kernel<T><<<(unsigned)grid, kVecThreads, 0, st>>>(
        (const int8_t*)q, (const float*)s, (T*)out, nvec, vpb, shift);
  } else if (path == kPathBlock) {
    dequant_block_kernel<T><<<block_grid(nblocks), block_threads(block), 0, st>>>(
        (const int8_t*)q, (const float*)s, (T*)out, block, nblocks);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {
// x: (rows, n) f32 or bf16, contiguous; q: (rows, n) int8; s: (rows, n / block)
// f32. path: 1 warp path (block 256, x 16-byte aligned), 0 block path.
int quant_int8_f32(const void* x, void* q, void* s, int64_t rows, int64_t n, int block,
                   int path, void* stream) {
  return quant_launch<float>(x, q, s, rows, n, block, path, stream);
}

int quant_int8_bf16(const void* x, void* q, void* s, int64_t rows, int64_t n, int block,
                    int path, void* stream) {
  return quant_launch<__nv_bfloat16>(x, q, s, rows, n, block, path, stream);
}

// q: (rows, n) int8, contiguous; s: (rows, n / block) f32; out: (rows, n).
// path: 1 vector path (block a multiple of 16, q 16-byte aligned), 0 block path.
int dequant_int8_f32(const void* q, const void* s, void* out, int64_t rows, int64_t n,
                     int block, int path, void* stream) {
  return dequant_launch<float>(q, s, out, rows, n, block, path, stream);
}

int dequant_int8_bf16(const void* q, const void* s, void* out, int64_t rows, int64_t n,
                      int block, int path, void* stream) {
  return dequant_launch<__nv_bfloat16>(q, s, out, rows, n, block, path, stream);
}
}
