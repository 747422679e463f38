// Fused RMSNorm forward for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (fused_rmsnorm_2d -> _rmsnorm_kernel).
//
// Bound on this card: bytes.  Per row it reads D values of x and writes D
// values of y, with the weight (D values) shared by every row and served from
// L2; at 2 operations per element the arithmetic intensity is far below the
// ~295 operations per byte where the tensor cores become the limit.  So the
// design moves each byte of x once: one block per row copies the row from
// device memory into shared memory with 16-byte vector loads (falling back to
// element loads where the row is not 16-byte aligned), reduces the fp32 sum
// of squares from there (warp shuffles, then one partial per warp in shared
// memory), and writes y from shared memory.  Ragged rows need no padding:
// the grid has exactly one block per row.  Statistics are fp32; the output
// is stored in an explicit dtype (x's by default, the model's compute dtype
// from the layer).
//
// C interface (ctypes): every pointer and the stream are void*, dtype codes
// are 0 = float32, 1 = bfloat16; returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TO* __restrict__ y, int d, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TX* row_s = reinterpret_cast<TX*>(smem_raw);
  __shared__ float warp_sums[kThreads / 32];

  const int64_t row = blockIdx.x;
  const TX* xr = x + row * d;
  TO* yr = y + row * d;

  // 1. the row, device memory -> shared memory, once
  constexpr int kVec = 16 / sizeof(TX);
  const bool vec_ok = (d % kVec == 0) &&
                      ((reinterpret_cast<uintptr_t>(xr) & 15) == 0);
  if (vec_ok) {
    const uint4* src = reinterpret_cast<const uint4*>(xr);
    uint4* dst = reinterpret_cast<uint4*>(row_s);
    for (int i = threadIdx.x; i < d / kVec; i += kThreads) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads) row_s[i] = xr[i];
  }
  __syncthreads();

  // 2. fp32 sum of squares: per thread, per warp, per block
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(row_s[i]);
    ss += v * v;
  }
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int i = 0; i < kThreads / 32; ++i) total += warp_sums[i];
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

  // 3. scale and store in the output dtype
  for (int i = threadIdx.x; i < d; i += kThreads) {
    yr[i] = from_f32<TO>((to_f32(row_s[i]) * r) * to_f32(w[i]));
  }
}

template <typename TX, typename TW, typename TO>
int launch(const void* x, const void* w, void* y, int64_t n, int d, float eps,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(d) * sizeof(TX);
  if (n > 0) {
    rmsnorm_kernel<TX, TW, TO><<<static_cast<unsigned>(n), kThreads, smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w),
        static_cast<TO*>(y), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int dispatch_out(int out_dtype, const void* x, const void* w, void* y,
                 int64_t n, int d, float eps, cudaStream_t s) {
  if (out_dtype == 0) return launch<TX, TW, float>(x, w, y, n, d, eps, s);
  if (out_dtype == 1) return launch<TX, TW, __nv_bfloat16>(x, w, y, n, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TX>
int dispatch_w(int w_dtype, int out_dtype, const void* x, const void* w,
               void* y, int64_t n, int d, float eps, cudaStream_t s) {
  if (w_dtype == 0) return dispatch_out<TX, float>(out_dtype, x, w, y, n, d, eps, s);
  if (w_dtype == 1) return dispatch_out<TX, __nv_bfloat16>(out_dtype, x, w, y, n, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* w, void* y, int64_t n,
                           int d, float eps, int x_dtype, int w_dtype,
                           int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return dispatch_w<float>(w_dtype, out_dtype, x, w, y, n, d, eps, s);
  if (x_dtype == 1)
    return dispatch_w<__nv_bfloat16>(w_dtype, out_dtype, x, w, y, n, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
