// Flash-attention forward for Hopper (sm_90a), online softmax, native GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd -> _flash_fwd_kernel).
//
// What it computes, as the TPU kernel does: for query row i of batch b and
// head h, softmax(q k^T / sqrt(D)) v over the keys j of KV head h / (H/K)
// with j < kv_len[b] and, when causal, j <= q_offset[b] + i.  Masked scores
// are -1e30; m, l and the accumulator are fp32; a row with no visible key is
// written as zeros; the output has q's dtype.  With q_offset = 0 and a uniform
// kv_len this is the TPU kernel's mask (top-left causal, k_pos < kv_valid);
// with the paged serve values it is the engine's absolute-position mask.
//
// Bound on this card.  Prefill chunks (256 queries against up to a few
// thousand keys) have an arithmetic intensity in the hundreds of operations
// per byte, so the bound is the tensor cores' rate; decode (one query per row)
// reads every visible K/V byte for 2 operations per byte, so the bound is
// memory.  This first kernel is simple rather than fast: it does the
// arithmetic in fp32 on the CUDA cores (no wgmma, TMA or split-KV yet), so it
// sits far from the operations bound on prefill.  What the design does about
// the bytes:
//   * the TPU grid's sequential KV axis becomes a loop inside the block, with
//     m, l and the accumulator in registers for the whole sweep;
//   * each block stages a 32-key K/V tile in shared memory once and every
//     one of its 16 query rows reuses it; GQA is an index (kv head =
//     h / (H/K)), so K/V are never repeated in device memory;
//   * tiles wholly past the causal edge or past kv_len are never loaded, so
//     a decode row reads only the keys its request has (data-dependent work);
//   * ragged Sq and Skv are masked, not padded.
// Layout: one block of 4 warps per (batch * head, 16-query tile); each warp
// owns 4 query rows; lane c scores key c of the tile (K rows padded by one
// float against bank conflicts), and lane c owns output columns c + 32 j.
//
// C interface (ctypes): every pointer and the stream are void*; q_offset and
// kv_len are int32 device arrays of B entries or null (0 and Skv); dtype 0 =
// float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // 16 query rows per block
constexpr int kBlockK = 32;                     // one key per lane
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ q_offset, const int* __restrict__ kv_len,
                 int sq, int skv, int heads, int kv_heads, int causal, float scale) {
  constexpr int kCols = D / 32;  // output columns per lane
  __shared__ float q_s[kBlockQ][D];
  __shared__ float k_s[kBlockK][D + 1];
  __shared__ float v_s[kBlockK][D];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int kh = h / (heads / kv_heads);
  const int q0 = blockIdx.y * kBlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int qoff = q_offset ? q_offset[b] : 0;
  int kvl = kv_len ? kv_len[b] : skv;
  kvl = min(max(kvl, 0), skv);
  // keys that any row of this tile may see; tiles past it are skipped
  int n_keys = kvl;
  if (causal) n_keys = min(n_keys, max(qoff + min(q0 + kBlockQ, sq), 0));

  for (int idx = threadIdx.x; idx < kBlockQ * D; idx += kWarps * 32) {
    const int r = idx / D, d = idx % D, qi = q0 + r;
    q_s[r][d] = qi < sq
        ? to_f32(q[((static_cast<int64_t>(b) * sq + qi) * heads + h) * D + d]) * scale
        : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();

  for (int kb = 0; kb < n_keys; kb += kBlockK) {
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kWarps * 32) {
      const int c = idx / D, d = idx % D, kj = kb + c;
      float kv = 0.f, vv = 0.f;
      if (kj < n_keys) {
        const int64_t off = ((static_cast<int64_t>(b) * skv + kj) * kv_heads + kh) * D + d;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      k_s[c][d] = kv;
      v_s[c][d] = vv;
    }
    __syncthreads();

    // scores: lane = key of the tile, 4 rows at once (one K read per d)
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] += q_s[warp * kRowsPerWarp + i][d] * kd;
    }

    const int kj = kb + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int qi = q0 + warp * kRowsPerWarp + i;
      const bool visible = kj < kvl && (!causal || kj <= qoff + qi);
      const float si = visible ? s[i] : kNegInf;
      const float m_new = fmaxf(m[i], warp_max(si));
      // a row with nothing visible yet keeps p = 0 (the TPU kernel's guard)
      float pi = m_new > kNegInf * 0.5f ? expf(si - m_new) : 0.f;
      const float corr = m[i] > kNegInf * 0.5f ? expf(m[i] - m_new) : 0.f;
      l[i] = l[i] * corr + warp_sum(pi);
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= corr;
      m[i] = m_new;
      p[i] = pi;
    }

    // accumulate p v: lane owns columns lane + 32 j; p of key c comes by shuffle
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float vc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vc[j] = v_s[c][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float pc = __shfl_sync(0xffffffffu, p[i], c);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] += pc * vc[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int qi = q0 + warp * kRowsPerWarp + i;
    if (qi >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<int64_t>(b) * sq + qi) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[lane + 32 * j] = from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const void* q_offset, const void* kv_len, int batch, int sq,
           int skv, int heads, int kv_heads, int causal, float scale,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((sq + kBlockQ - 1) / kBlockQ));
  if (grid.x > 0 && grid.y > 0) {
    flash_fwd_kernel<T, D><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(o),
        static_cast<const int*>(q_offset), static_cast<const int*>(kv_len),
        sq, skv, heads, kv_heads, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               const void* q_offset, const void* kv_len, int batch, int sq,
               int skv, int heads, int kv_heads, int causal, float scale,
               cudaStream_t s) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, q_offset, kv_len, batch, sq, skv, heads, kv_heads, causal, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, q_offset, kv_len, batch, sq, skv, heads, kv_heads, causal, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, q_offset, kv_len, batch, sq, skv, heads, kv_heads, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const void* q_offset,
                                   const void* kv_len, int batch, int sq,
                                   int skv, int heads, int kv_heads, int d,
                                   int causal, float scale, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, o, q_offset, kv_len, batch, sq, skv, heads, kv_heads, causal, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, q_offset, kv_len, batch, sq, skv, heads, kv_heads, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
