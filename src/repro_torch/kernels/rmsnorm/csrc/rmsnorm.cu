// Fused RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (fused_rmsnorm_2d -> _rmsnorm_kernel).
//
// Bound on this card: bytes.  Per row it reads D values of x and writes D
// values of y, with the weight (D values) shared by every row and served from
// L1/L2; at a few operations per element the arithmetic intensity is far below
// the ~295 operations per byte where the tensor cores become the limit.  So
// the design moves each byte once, in wide accesses, with nothing between
// the load and the store but registers:
//   * one warp per row, four rows per block of 128 threads; the row is held in
//     registers as chunks of 8 elements (16 bytes of bf16, 32 of fp32), lane
//     c holding chunks c, c + 32, ...: 10 chunks a lane at 2560 bf16;
//   * the fp32 sum of squares is reduced by warp shuffles alone: no shared
//     memory and no __syncthreads on this path;
//   * w is read as 16-byte fp32 (or bf16) vectors, in groups of 8 chunks
//     whose loads issue together (the first beside x's), y written as
//     16-byte vectors; the weight and output dtypes are template arguments,
//     so no branch stands between a group's loads;
//   * a warp's lanes hold 8, 10 or 16 chunks each (the serve path's 2048
//     and the train path's 2560 take the first two); rows over 4096
//     elements go to a variant where the 8 warps of a 256-thread block
//     share a row (one shared-memory partial per warp, one barrier), up to
//     48 KB;
//   * a row whose width is not a multiple of 8, whose pointers are not
//     16-byte aligned, or which is wider than 48 KB takes a scalar path (a
//     warp per row, element loads, x read twice).
// rmsnorm_path() names the variant a call takes, from the same rule.
// Statistics are fp32; the output is stored in an explicit dtype (x's by
// default, the model's compute dtype from the layer).
//
// C interface (ctypes): every pointer and the stream are void*, dtype codes
// are 0 = float32, 1 = bfloat16; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;           // elements per chunk
constexpr int kWideThreads = 256;   // threads sharing one wide row
constexpr int kWideBytes = 48 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// a chunk of x as loaded: 16 bytes of bf16 or 32 bytes of fp32
template <typename T> struct Chunk;

template <> struct Chunk<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) { u = *reinterpret_cast<const uint4*>(p); }
  __device__ __forceinline__ void get(float (&f)[kChunk]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

template <> struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = reinterpret_cast<const float4*>(p)[0];
    b = reinterpret_cast<const float4*>(p)[1];
  }
  __device__ __forceinline__ void get(float (&f)[kChunk]) const {
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// 8 outputs, 16-byte stores
__device__ __forceinline__ void store_chunk(float* p, const float (&f)[kChunk]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* p, const float (&f)[kChunk]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// kThreadsRow threads per row (32: a warp, no shared memory; kWideThreads:
// the block), each holding at most kPer chunks of the row in registers.  The
// weights come in groups of kWGroup chunks, each group's loads issued
// together (the first group's beside x's, before the reduction), so a row
// waits on a few round trips to L1/L2, not one per chunk.
template <typename TX, typename TW, typename TO, int kThreadsRow, int kPer>
__global__ void __launch_bounds__(kThreadsRow == 32 ? 128 : kThreadsRow)
rmsnorm_vec_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                   TO* __restrict__ y, int64_t n, int d, float eps) {
  constexpr int kRowsBlock = kThreadsRow == 32 ? 4 : 1;
  constexpr int kWGroup = kPer < 8 ? kPer : 8;
  const int t = threadIdx.x % kThreadsRow;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsBlock + threadIdx.x / kThreadsRow;
  const bool row_ok = row < n;
  if (kThreadsRow == 32 && !row_ok) return;  // whole warps only
  const int n_chunks = d / kChunk;
  const TX* xr = x + row * d;
  TO* yr = y + row * d;

  Chunk<TX> c[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int ch = t + i * kThreadsRow;
    if (row_ok && ch < n_chunks) c[i].load(xr + ch * kChunk);
  }
  Chunk<TW> wc[kWGroup];
#pragma unroll
  for (int i = 0; i < kWGroup; ++i) {
    const int ch = t + i * kThreadsRow;
    if (ch < n_chunks) wc[i].load(w + ch * kChunk);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int ch = t + i * kThreadsRow;
    if (row_ok && ch < n_chunks) {
      float f[kChunk];
      c[i].get(f);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) ss += f[j] * f[j];
    }
  }
  ss = warp_sum(ss);
  if constexpr (kThreadsRow > 32) {
    __shared__ float part[kThreadsRow / 32];
    if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int i = 0; i < kThreadsRow / 32; ++i) ss += part[i];
  }
  if (!row_ok) return;
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int g0 = 0; g0 < kPer; g0 += kWGroup) {
    if (g0 > 0) {
#pragma unroll
      for (int i = 0; i < kWGroup; ++i) {
        const int ch = t + (g0 + i) * kThreadsRow;
        if (g0 + i < kPer && ch < n_chunks) wc[i].load(w + ch * kChunk);
      }
    }
#pragma unroll
    for (int i = 0; i < kWGroup; ++i) {
      const int ch = t + (g0 + i) * kThreadsRow;
      if (g0 + i < kPer && ch < n_chunks) {
        float f[kChunk], wf[kChunk];
        c[g0 + i].get(f);
        wc[i].get(wf);
#pragma unroll
        for (int j = 0; j < kChunk; ++j) f[j] = (f[j] * r) * wf[j];
        store_chunk(yr + ch * kChunk, f);
      }
    }
  }
}

__device__ __forceinline__ float load_elem(const void* p, int64_t i, int dtype) {
  return dtype == 0 ? static_cast<const float*>(p)[i]
                    : __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// any width or alignment: a warp per row, element loads
template <typename TX>
__global__ void __launch_bounds__(128)
rmsnorm_scalar_kernel(const TX* __restrict__ x, const void* __restrict__ w,
                      void* __restrict__ y, int64_t n, int d, float eps,
                      int w_dtype, int out_dtype) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (row >= n) return;
  const int lane = threadIdx.x & 31;
  const TX* xr = x + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  const float r = rsqrtf(warp_sum(ss) / static_cast<float>(d) + eps);
  for (int i = lane; i < d; i += 32) {
    const float v = (to_f32(xr[i]) * r) * load_elem(w, i, w_dtype);
    if (out_dtype == 0)
      static_cast<float*>(y)[row * d + i] = v;
    else
      static_cast<__nv_bfloat16*>(y)[row * d + i] = __float2bfloat16(v);
  }
}

template <typename TX, typename TW, typename TO, int kThreadsRow, int kPer>
void launch_vec(const void* x, const void* w, void* y, int64_t n, int d,
                float eps, cudaStream_t s) {
  constexpr int kRowsBlock = kThreadsRow == 32 ? 4 : 1;
  constexpr int kBlock = kThreadsRow == 32 ? 128 : kThreadsRow;
  const unsigned blocks = static_cast<unsigned>((n + kRowsBlock - 1) / kRowsBlock);
  rmsnorm_vec_kernel<TX, TW, TO, kThreadsRow, kPer><<<blocks, kBlock, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TO*>(y), n, d, eps);
}

enum Path { kScalar = 0, kWarp = 1, kBlock = 2 };
constexpr int kWarpMaxPer = 16;     // chunks a lane: rows up to 4096 elements

Path choose_path(int d, int x_size, bool aligned) {
  if (d % kChunk != 0 || !aligned || static_cast<int64_t>(d) * x_size > kWideBytes)
    return kScalar;
  return (d / kChunk + 31) / 32 <= kWarpMaxPer ? kWarp : kBlock;
}

// one warp a row in the smallest bucket of chunks a lane that holds the
// row's share; else the block shares the row
template <typename TX, typename TW, typename TO>
void launch_vec_any(const void* x, const void* w, void* y, int64_t n, int d,
                    float eps, cudaStream_t s) {
  const int per = (d / kChunk + 31) / 32;
  if (per <= 8) launch_vec<TX, TW, TO, 32, 8>(x, w, y, n, d, eps, s);
  else if (per <= 10) launch_vec<TX, TW, TO, 32, 10>(x, w, y, n, d, eps, s);
  else if (per <= kWarpMaxPer) launch_vec<TX, TW, TO, 32, kWarpMaxPer>(x, w, y, n, d, eps, s);
  else {
    constexpr int kPer = kWideBytes / kWideThreads / (kChunk * sizeof(TX));
    launch_vec<TX, TW, TO, kWideThreads, kPer>(x, w, y, n, d, eps, s);
  }
}

template <typename TX, typename TW>
void launch_vec_w(int out_dtype, const void* x, const void* w, void* y,
                  int64_t n, int d, float eps, cudaStream_t s) {
  if (out_dtype == 0) launch_vec_any<TX, TW, float>(x, w, y, n, d, eps, s);
  else launch_vec_any<TX, TW, __nv_bfloat16>(x, w, y, n, d, eps, s);
}

template <typename TX>
int launch(const void* x, const void* w, void* y, int64_t n, int d, float eps,
           int w_dtype, int out_dtype, cudaStream_t s) {
  if (n <= 0 || d <= 0) return static_cast<int>(cudaGetLastError());
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (choose_path(d, sizeof(TX), aligned(x) && aligned(w) && aligned(y)) != kScalar) {
    if (w_dtype == 0) launch_vec_w<TX, float>(out_dtype, x, w, y, n, d, eps, s);
    else launch_vec_w<TX, __nv_bfloat16>(out_dtype, x, w, y, n, d, eps, s);
  } else {
    rmsnorm_scalar_kernel<TX><<<static_cast<unsigned>((n + 3) / 4), 128, 0, s>>>(
        static_cast<const TX*>(x), w, y, n, d, eps, w_dtype, out_dtype);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int64_t n,
                           int d, float eps, int x_dtype, int w_dtype,
                           int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((w_dtype != 0 && w_dtype != 1) || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0) return launch<float>(x, w, y, n, d, eps, w_dtype, out_dtype, s);
  if (x_dtype == 1) return launch<__nv_bfloat16>(x, w, y, n, d, eps, w_dtype, out_dtype, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the variant rmsnorm_fwd takes for a row of d elements of x_dtype whose
// pointers are all 16-byte aligned (aligned != 0) or not: 0 scalar, 1 a warp
// a row, 2 a block a row; -1 for an unknown dtype
extern "C" int rmsnorm_path(int d, int x_dtype, int aligned) {
  if (x_dtype != 0 && x_dtype != 1) return -1;
  return choose_path(d, x_dtype == 0 ? 4 : 2, aligned != 0);
}
