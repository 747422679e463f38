// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan_pallas -> _ssd_kernel).
//
// What it computes, as the TPU kernel does, for batch b and head h, chunk by
// chunk of Q tokens with the (n x p) fp32 state carried from one chunk to the
// next (zero before the first):
//   cum   = inclusive cumsum of dt * A within the chunk        (Q,)
//   y     = ((C B^T) o tril(exp(cum_q - cum_t))) (x dt) + (C exp(cum)) state
//   state = state exp(cum_end) + (B exp(cum_end - cum))^T (x dt)
// Outputs: y (b, S, h, p) in an explicit dtype, the final state (b, h, n, p)
// in fp32.  All decays are exp of non-positive numbers (dt >= 0, A < 0).
//
// Bound on this card.  Per chunk and head the function needs four small
// products (21 M operations at Q = 256, n = 128, p = 64, the triangle only).
// On the train path's call (b = 2, S = 2048, 80 heads) that is 2.7e10
// operations on 134.5 MB read and written once, about 200 operations a byte:
// below the tensor cores' ~295, so the data-sheet bound is the bytes
// (0.040 ms).  This first kernel does the arithmetic in fp32 on the CUDA
// cores (no mma/wgmma), at a 67 TFLOP/s peak, so what bounds it is that
// arithmetic (0.40 ms at peak).  What the design does about it:
//   * the TPU grid's sequential chunk axis becomes a loop inside one block per
//     (batch, head), with the state in shared memory for the whole sequence;
//   * the TPU kernel's whole-chunk (Q x Q) fp32 scores tile (256 KB at Q = 256)
//     does not fit a block's 227 KB, so query rows go 64 at a time and key
//     tiles of 64 run up to the diagonal; tiles above it are skipped, which
//     halves the intra-chunk work;
//   * C (query tile) and B (key tile, stored transposed) are staged in their
//     input dtype as they arrive (bf16 on the model path), x dt in fp32; the
//     shared memory of a bf16 block is ~100 KB, so two blocks share an SM;
//   * the last query tile visits every key tile of the chunk, so the state's
//     update is accumulated there, in registers, from the tiles already staged;
//   * B and C may carry any head stride, 0 included: the model's ngroups = 1
//     broadcast over 80 heads is never copied to device memory.
//   * the within-chunk cumsum of dt A is kept in fp64: the decays are
//     exp(cum_q - cum_t), and at Q = 256 cum reaches a few hundred, where an
//     fp32 prefix sum loses ~1e-4 of the difference of two nearby entries
//     (a relative error of the decay, times terms of order 10 in y).
// Each thread of 256 owns a 4 x 4 output micro-tile (rows ty + 16 i, columns
// tx + 16 j) of every 64 x 64 product and 8 x 4 entries of the state update.
//
// C interface (ctypes): pointers and the stream are void*; strides are in
// elements, for the (batch, seq, head) axes (the last axis is contiguous);
// dtype codes 0 = float32, 1 = bfloat16 (x, B and C share one; dt and A are
// fp32).  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes it does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows of a query or key tile
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMaxN = 128;      // d_state
constexpr int kMaxP = 64;       // head_dim

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {
  int64_t b, s, h;
};

// Row pitches padded by one 32-bit word against bank conflicts: the two
// rows a warp reads at once (ty, ty + 1) then sit in different banks, and a
// row of B (one token, n contiguous values) stored down a column of the
// transposed tile spreads over all 32.
template <typename T> __host__ __device__ constexpr int bt_pitch() { return kT + 4 / (int)sizeof(T); }
template <typename T> __host__ __device__ constexpr int c_pitch() { return kMaxN + 4 / (int)sizeof(T); }
constexpr int kGPitch = kT + 1;

template <typename T> size_t smem_bytes(int q) {
  const int qr = (q + kT - 1) / kT * kT;
  return sizeof(float) * (kMaxN * kMaxP      // state
                          + kT * kGPitch     // scores tile
                          + kT * kMaxP       // x dt of the key tile
                          + 2 * qr)          // dt, exp(cum_end - cum)
         + sizeof(double) * qr               // cum
         + sizeof(T) * (kT * c_pitch<T>()    // C, query tile
                        + kMaxN * bt_pitch<T>());  // B^T, key tile
}

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ B,
                const T* __restrict__ C, const float* __restrict__ dt,
                const float* __restrict__ A, TO* __restrict__ y,
                float* __restrict__ state_out, int heads, int seqlen, int p,
                int n, int q, Strides sx, Strides sb, Strides sc, Strides sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qr = (q + kT - 1) / kT * kT;
  float* st = reinterpret_cast<float*>(smem_raw);  // [kMaxN][kMaxP]
  float* g = st + kMaxN * kMaxP;                   // [kT][kGPitch]
  float* xs = g + kT * kGPitch;                    // [kT][kMaxP]
  float* dtv = xs + kT * kMaxP;                    // [qr]
  float* wend = dtv + qr;                          // [qr]
  double* cum = reinterpret_cast<double*>(wend + qr);  // [qr]; 8-byte aligned,
                                                   // as qr is a multiple of 64
  T* cs = reinterpret_cast<T*>(cum + qr);          // [kT][c_pitch]
  T* bt = cs + kT * c_pitch<T>();                  // [kMaxN][bt_pitch]
  constexpr int kPitch = bt_pitch<T>(), kCPitch = c_pitch<T>();
  __shared__ double warp_tot[kThreads / 32];
  __shared__ double carry_s;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int bi = blockIdx.x / heads, hi = blockIdx.x % heads;
  const float a = A[hi];
  const T* xb = x + bi * sx.b + hi * sx.h;
  const T* bb = B + bi * sb.b + hi * sb.h;
  const T* cb = C + bi * sc.b + hi * sc.h;
  const float* db = dt + bi * sd.b + hi * sd.h;
  const int64_t y_row = static_cast<int64_t>(heads) * p;  // y is contiguous
  TO* yb = y + static_cast<int64_t>(bi) * seqlen * y_row + static_cast<int64_t>(hi) * p;

  for (int i = tid; i < kMaxN * kMaxP; i += kThreads) st[i] = 0.f;

  const int ntiles = qr / kT;
  const int nchunks = seqlen / q;
  for (int c = 0; c < nchunks; ++c) {
    const int64_t s0 = static_cast<int64_t>(c) * q;

    // 1. dt of the chunk, then cum = inclusive cumsum of dt * A in fp64
    //    (block scan, 256 tokens a pass, the running total carried between
    //    passes); each term dt * A is rounded to fp32 first, as in the
    //    plain version
    for (int i = tid; i < qr; i += kThreads) dtv[i] = i < q ? db[(s0 + i) * sd.s] : 0.f;
    if (tid == 0) carry_s = 0.f;
    __syncthreads();
    for (int base = 0; base < qr; base += kThreads) {
      const int i = base + tid;
      double v = i < q ? static_cast<double>(dtv[i] * a) : 0.0;
      for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
      }
      if (lane == 31) warp_tot[warp] = v;
      __syncthreads();
      double before = carry_s;
      for (int w = 0; w < warp; ++w) before += warp_tot[w];
      if (i < qr) cum[i] = v + before;
      __syncthreads();
      if (tid == kThreads - 1) carry_s = v + before;
      __syncthreads();
    }
    const double cum_end = cum[q - 1];
    for (int i = tid; i < qr; i += kThreads)
      wend[i] = i < q ? expf(static_cast<float>(cum_end - cum[i])) : 0.f;

    float sacc[8][4];  // state update: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;

    for (int qt = 0; qt < ntiles; ++qt) {
      const int q0 = qt * kT, qn = min(kT, q - q0);
      __syncthreads();  // the previous tile's readers of cs are done
      for (int i = tid; i < kT * n; i += kThreads) {
        const int r = i / n, k = i % n;
        cs[r * kCPitch + k] = r < qn ? cb[(s0 + q0 + r) * sc.s + k] : from_f32<T>(0.f);
      }
      __syncthreads();

      // 2. inter-chunk: y = exp(cum_q) * (C state_in)
      float yacc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[i][j] = 0.f;
      for (int k = 0; k < n; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = to_f32(cs[(ty + 16 * i) * kCPitch + k]);
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = st[k * kMaxP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yacc[i][j] = fmaf(av[i], bv[j], yacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const float e = r < qn ? expf(static_cast<float>(cum[q0 + r])) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) yacc[i][j] *= e;
      }

      // 3. intra-chunk, key tiles up to the diagonal
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kT, kn = min(kT, q - k0);
        __syncthreads();  // readers of bt, xs and g are done
        for (int i = tid; i < kT * n; i += kThreads) {
          const int t = i / n, k = i % n;
          bt[k * kPitch + t] = t < kn ? bb[(s0 + k0 + t) * sb.s + k] : from_f32<T>(0.f);
        }
        for (int i = tid; i < kT * kMaxP; i += kThreads) {
          const int t = i / kMaxP, j = i % kMaxP;
          xs[i] = (t < kn && j < p)
                      ? to_f32(xb[(s0 + k0 + t) * sx.s + j]) * dtv[k0 + t]
                      : 0.f;
        }
        __syncthreads();

        // scores = (C B^T) o L on this (query tile, key tile) pair
        float gacc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gacc[i][j] = 0.f;
        for (int k = 0; k < n; ++k) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = to_f32(cs[(ty + 16 * i) * kCPitch + k]);
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = to_f32(bt[k * kPitch + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) gacc[i][j] = fmaf(av[i], bv[j], gacc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = tx + 16 * j, ti = k0 + t;
            const bool keep = r < qn && t < kn && qi >= ti;
            g[r * kGPitch + t] =
                keep ? gacc[i][j] * expf(static_cast<float>(cum[qi] - cum[ti])) : 0.f;
          }
        }
        __syncthreads();

        // y += scores (x dt), summed per key tile first: partial sums of 64
        // terms keep fp32 rounding closer to a blocked product's
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) gacc[i][j] = 0.f;
        for (int t = 0; t < kn; ++t) {
          float av[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = g[(ty + 16 * i) * kGPitch + t];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = xs[t * kMaxP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) gacc[i][j] = fmaf(av[i], bv[j], gacc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) yacc[i][j] += gacc[i][j];

        // 4. the last query tile sees every key tile: the chunk's state input
        //    (B exp(cum_end - cum))^T (x dt), from the tiles staged here
        if (qt == ntiles - 1) {
          for (int t = 0; t < kn; ++t) {
            const float w = wend[k0 + t];
            float av[8], bv[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int r = ty + 16 * i;
              av[i] = r < n ? to_f32(bt[r * kPitch + t]) : 0.f;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = xs[t * kMaxP + tx + 16 * j] * w;
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) sacc[i][j] = fmaf(av[i], bv[j], sacc[i][j]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= qn) continue;
        TO* yr = yb + (s0 + q0 + r) * y_row;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          if (col < p) yr[col] = from_f32<TO>(yacc[i][j]);
        }
      }
    }

    // 5. state = state exp(cum_end) + the chunk's input, once every query
    //    tile has read the state it entered with
    __syncthreads();
    const float total = expf(static_cast<float>(cum_end));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 16 * i;
      if (r >= n) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        if (col < p) st[r * kMaxP + col] = st[r * kMaxP + col] * total + sacc[i][j];
      }
    }
    __syncthreads();
  }

  float* so = state_out + (static_cast<int64_t>(bi) * heads + hi) * n * p;
  for (int i = tid; i < n * p; i += kThreads) so[i] = st[(i / p) * kMaxP + i % p];
}

template <typename T, typename TO>
int launch(const void* x, const void* B, const void* C, const void* dt,
           const void* A, void* y, void* state, int batch, int seqlen,
           int heads, int p, int n, int q, Strides sx, Strides sb, Strides sc,
           Strides sd, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = batch * heads;
  if (blocks > 0) {
    ssd_scan_kernel<T, TO><<<blocks, kThreads, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(B),
        static_cast<const T*>(C), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<TO*>(y),
        static_cast<float*>(state), heads, seqlen, p, n, q, sx, sb, sc, sd);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_out(int out_dtype, const void* x, const void* B, const void* C,
                 const void* dt, const void* A, void* y, void* state,
                 int batch, int seqlen, int heads, int p, int n, int q,
                 Strides sx, Strides sb, Strides sc, Strides sd,
                 cudaStream_t s) {
  if (out_dtype == 0)
    return launch<T, float>(x, B, C, dt, A, y, state, batch, seqlen, heads, p,
                            n, q, sx, sb, sc, sd, s);
  if (out_dtype == 1)
    return launch<T, __nv_bfloat16>(x, B, C, dt, A, y, state, batch, seqlen,
                                    heads, p, n, q, sx, sb, sc, sd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Largest dynamic shared memory a block may use on this card (227 KB).
constexpr size_t kMaxSmem = 232448;

extern "C" int ssd_scan_fwd(const void* x, const void* B, const void* C,
                            const void* dt, const void* A, void* y,
                            void* state, int batch, int seqlen, int heads,
                            int p, int n, int chunk, int64_t xsb, int64_t xss,
                            int64_t xsh, int64_t bsb, int64_t bss,
                            int64_t bsh, int64_t csb, int64_t css,
                            int64_t csh, int64_t dsb, int64_t dss,
                            int64_t dsh, int in_dtype, int out_dtype,
                            void* stream) {
  if (p < 1 || p > kMaxP || n < 1 || n > kMaxN || chunk < 1 ||
      seqlen % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = in_dtype == 0 ? smem_bytes<float>(chunk)
                                    : smem_bytes<__nv_bfloat16>(chunk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const Strides sx{xsb, xss, xsh}, sb{bsb, bss, bsh}, sc{csb, css, csh},
      sd{dsb, dss, dsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return dispatch_out<float>(out_dtype, x, B, C, dt, A, y, state, batch,
                               seqlen, heads, p, n, chunk, sx, sb, sc, sd, s);
  if (in_dtype == 1)
    return dispatch_out<__nv_bfloat16>(out_dtype, x, B, C, dt, A, y, state,
                                       batch, seqlen, heads, p, n, chunk, sx,
                                       sb, sc, sd, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
