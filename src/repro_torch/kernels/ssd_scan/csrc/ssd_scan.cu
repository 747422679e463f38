// Mamba-2 SSD chunked scan, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py:96
// (ssd_scan_pallas -> _ssd_kernel, lines 29-81).
//
// What it computes, as the TPU kernel does, for batch b and head h, chunk by
// chunk of Q tokens with the (n x p) fp32 state carried from one chunk to the
// next (zero before the first):
//   cum   = inclusive cumsum of dt * A within the chunk        (Q,)
//   y     = ((C B^T) o tril(exp(cum_q - cum_t))) (x dt) + (C exp(cum)) state
//   state = state exp(cum_end) + (B exp(cum_end - cum))^T (x dt)
// Outputs: y (b, S, h, p) in an explicit dtype, the final state (b, h, n, p)
// in fp32.  The model's decays are exp of non-positive numbers (dt >= 0 from
// a softplus, A < 0); the kernels take any dt, as the plain version does.
//
// Bound on this card.  Per chunk and head the function needs four small
// products (21 M operations at Q = 256, n = 128, p = 64, the triangle only).
// On the train path's call (b = 2, S = 2048, 80 heads) that is 2.7e10
// operations on 134.5 MB read and written once, about 200 operations a byte:
// below the tensor cores' ~295, so the data-sheet bound is the bytes
// (0.040 ms); the same operations take 0.027 ms at the tensor cores' bf16
// peak and 0.40 ms at the CUDA cores' fp32 peak.  So the arithmetic has to
// run on the tensor cores, and the grid has to fill 132 SMs: the TPU grid
// walks the chunks of a (batch, head) in order, and one block per (batch,
// head) walking them (160 blocks at the train shape) leaves most of the card
// waiting on eight serial chunk steps.
//
// bf16 (the train and SSM paths): the SSD paper's chunk-parallel form
// (arXiv:2405.21060 §6), three kernels on the stream, the second and third
// launched as programmatic dependents of the one before (their launch and
// prologue overlap the previous kernel's tail; griddepcontrol.wait orders
// the data):
//   1. ssd_chunk_state_kernel, a block per (batch, chunk, head), 4 warps:
//      the within-chunk cumsum of dt A in fp64 (fp32 lost ~1e-4 of the
//      difference of two nearby entries at Q = 256 and missed the fp32
//      check by 2x), written to scratch with exp(cum_end); then the chunk's
//      state input S_c = B^T (x dt exp(cum_end - cum)), a (n x Q)(Q x p)
//      product, warp w owning state rows [32 w, 32 w + 32).  B and x tiles
//      of 64 tokens stream through a ring of two (rings of three and four
//      measured slower: fewer blocks an SM).
//   2. ssd_state_pass_kernel, four state columns a thread, serial over the
//      chunks with a group of chunks' loads in flight: st_in[c] = st,
//      written as bf16 high and low parts for kernel 3; st = st
//      exp(cum_end[c]) + S_c; the last st is the output state.
//   3. ssd_chunk_out_kernel, a block per (batch, chunk, head, 128 query
//      rows), 4 warps, two blocks an SM.  Warp w owns the 16-row tiles w
//      and 7 - w, so every warp has the same number of keys up to the
//      diagonal.  C's fragments stay in registers; the entering state's
//      part exp(cum_q) (C st_in) comes first, then 16 keys at a time S =
//      C B^T (each B fragment serving both row tiles), scaled in fp32 by
//      exp2 of the row's and the key's exponents and by the key's dt,
//      masked above the diagonal, and y += S x.  Key groups
//      wholly above a row tile are skipped; a (chunk, head)'s row blocks
//      are adjacent in the grid, the longest first, so its x tiles and
//      entering state are read from device memory once.
//   All products are mma.sync m16n8k16 in bf16 with fp32 accumulators (as
//   the flash-attention kernel's).  C, B and x are bf16 inputs and enter as
//   they are (ldmatrix, .trans where the stored layout is the transpose).
//   Three operands are formed in fp32 and enter as bf16 high and low parts
//   (two products each, ~16 bits): x dt exp(cum_end - cum) in kernel 1, the
//   scaled scores and st_in in kernel 3.  Rounding any one of them once to
//   bf16 broke the 5e-2 check by up to 4.9x on the CPU's emulation at the
//   train shape (ref.py's bf16 option, tests/test_torch_ssd_plan.py): y
//   sums terms of up to a few hundred that cancel.  dt rides on the scores,
//   not on x, so x needs no rounding.
//   Tiles come in by 16-byte cp.async where the rows are 16-byte aligned,
//   else by element loads; rows are padded by 16 bytes so each ldmatrix
//   hits distinct banks.  B and C may carry any head stride, 0 included:
//   mamba2-2.7b's ngroups = 1 broadcast over 80 heads is never copied.
//   With that broadcast C B^T of a chunk is the same for all 80 heads; it
//   is computed per head all the same: a variant of kernel 3 without these
//   products (a throwaway build, not kept) saved only a minor part of its
//   time on the H100, which is all that a shared pre-pass could save, less
//   its own launch and the scores' L2 reads; and one code path serves
//   broadcast and per-head B and C.
//   What bounds the three kernels on the card (PERF.md): kernel 3's loads
//   and stores (x, st_in, y) and its 16-key steps' dependent mma chains,
//   with 240 registers a thread (ptxas); the scratch's round trip
//   through device memory (S_c and st_in, 42 MB each) in kernels 1 and 2.
//   Why mma.sync and not wgmma: the decay scaling sits between the two
//   products in registers, as the softmax does in flash attention; wgmma
//   and TMA are a later step.
//
// fp32 (the tests' fp32 check, the SSM path's fp32 compute option): the
// CUDA-core body, one block per (batch, head) walking the chunks with the
// state in shared memory; TF32 tensor cores would miss the 2e-4 check.
//
// C interface (ctypes): pointers and the stream are void*; strides are in
// elements, for the (batch, seq, head) axes (the last axis is contiguous);
// dtype codes 0 = float32, 1 = bfloat16 (x, B and C share one; dt and A are
// fp32).  bf16 takes the scratch the wrapper allocates as
// ops.py::launch_plan says (states (b, nc, h, 128, 64) fp32, st_in (b, nc,
// h, 2, 128, 64) bf16, cum (b, nc, h, Q) fp64, decay (b, nc, h) fp32) and
// sizes its grids and shared memory itself; `stages` is a bit mask of the
// kernels to run (7 = all; the checks run them one at a time).  Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// shapes it does not take.  ssd_scan_plan reports those launch sizes and the
// resident blocks an SM that the CUDA runtime gives each bf16 kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows of a query, key or token tile
constexpr int kMaxN = 128;      // d_state
constexpr int kMaxP = 64;       // head_dim

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Strides {
  int64_t b, s, h;
};

// Inclusive cumsum of dt * A over a chunk's q tokens (qr rounded up), in
// fp64: a block scan, kThreads tokens a pass, the running total carried
// between passes.  Each term dt * A is rounded to fp32 first, as in the plain
// version.  Ends with a barrier.
template <int kThreads>
__device__ void chunk_cumsum(const float* dtv, double* cum, int q, int qr, float a,
                             double* warp_tot, double* carry) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid == 0) *carry = 0.0;
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
    double before = *carry;
    for (int w = 0; w < warp; ++w) before += warp_tot[w];
    if (i < qr) cum[i] = v + before;
    __syncthreads();
    if (tid == kThreads - 1) *carry = v + before;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;   // 16 x 16 threads, 4 x 4 outputs each

// Row pitches padded by one 32-bit word against bank conflicts: the two
// rows a warp reads at once (ty, ty + 1) then sit in different banks, and a
// row of B (one token, n contiguous values) stored down a column of the
// transposed tile spreads over all 32.
constexpr int kF32BtPitch = kT + 1;
constexpr int kF32CPitch = kMaxN + 1;
constexpr int kGPitch = kT + 1;

size_t f32_smem_bytes(int q) {
  const int qr = (q + kT - 1) / kT * kT;
  return sizeof(float) * (kMaxN * kMaxP          // state
                          + kT * kGPitch         // scores tile
                          + kT * kMaxP           // x dt of the key tile
                          + 2 * qr               // dt, exp(cum_end - cum)
                          + kT * kF32CPitch      // C, query tile
                          + kMaxN * kF32BtPitch) // B^T, key tile
         + sizeof(double) * qr;                  // cum
}

// Each thread of 256 owns a 4 x 4 output micro-tile (rows ty + 16 i, columns
// tx + 16 j) of every 64 x 64 product and 8 x 4 entries of the state update;
// query rows go 64 at a time against key tiles up to the diagonal; the last
// query tile, which sees every key tile, accumulates the state update.
template <typename TO>
__global__ void __launch_bounds__(kF32Threads, 2)
ssd_scan_f32_kernel(const float* __restrict__ x, const float* __restrict__ B,
                    const float* __restrict__ C, const float* __restrict__ dt,
                    const float* __restrict__ A, TO* __restrict__ y,
                    float* __restrict__ state_out, int heads, int seqlen, int p,
                    int n, int q, Strides sx, Strides sb, Strides sc, Strides sd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qr = (q + kT - 1) / kT * kT;
  double* cum = reinterpret_cast<double*>(smem_raw);  // [qr]
  float* st = reinterpret_cast<float*>(cum + qr);     // [kMaxN][kMaxP]
  float* g = st + kMaxN * kMaxP;                      // [kT][kGPitch]
  float* xs = g + kT * kGPitch;                       // [kT][kMaxP]
  float* dtv = xs + kT * kMaxP;                       // [qr]
  float* wend = dtv + qr;                             // [qr]
  float* cs = wend + qr;                              // [kT][kF32CPitch]
  float* bt = cs + kT * kF32CPitch;                   // [kMaxN][kF32BtPitch]
  __shared__ double warp_tot[kF32Threads / 32];
  __shared__ double carry_s;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int bi = blockIdx.x / heads, hi = blockIdx.x % heads;
  const float a = A[hi];
  const float* xb = x + bi * sx.b + hi * sx.h;
  const float* bb = B + bi * sb.b + hi * sb.h;
  const float* cb = C + bi * sc.b + hi * sc.h;
  const float* db = dt + bi * sd.b + hi * sd.h;
  const int64_t y_row = static_cast<int64_t>(heads) * p;  // y is contiguous
  TO* yb = y + static_cast<int64_t>(bi) * seqlen * y_row + static_cast<int64_t>(hi) * p;

  for (int i = tid; i < kMaxN * kMaxP; i += kF32Threads) st[i] = 0.f;

  const int ntiles = qr / kT;
  const int nchunks = seqlen / q;
  for (int c = 0; c < nchunks; ++c) {
    const int64_t s0 = static_cast<int64_t>(c) * q;

    // 1. dt of the chunk, then cum in fp64
    for (int i = tid; i < qr; i += kF32Threads) dtv[i] = i < q ? db[(s0 + i) * sd.s] : 0.f;
    chunk_cumsum<kF32Threads>(dtv, cum, q, qr, a, warp_tot, &carry_s);
    const double cum_end = cum[q - 1];
    for (int i = tid; i < qr; i += kF32Threads)
      wend[i] = i < q ? expf(static_cast<float>(cum_end - cum[i])) : 0.f;

    float sacc[8][4];  // state update: rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = 0.f;

    for (int qt = 0; qt < ntiles; ++qt) {
      const int q0 = qt * kT, qn = min(kT, q - q0);
      __syncthreads();  // the previous tile's readers of cs are done
      for (int i = tid; i < kT * n; i += kF32Threads) {
        const int r = i / n, k = i % n;
        cs[r * kF32CPitch + k] = r < qn ? cb[(s0 + q0 + r) * sc.s + k] : 0.f;
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
        for (int i = 0; i < 4; ++i) av[i] = cs[(ty + 16 * i) * kF32CPitch + k];
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
        for (int i = tid; i < kT * n; i += kF32Threads) {
          const int t = i / n, k = i % n;
          bt[k * kF32BtPitch + t] = t < kn ? bb[(s0 + k0 + t) * sb.s + k] : 0.f;
        }
        for (int i = tid; i < kT * kMaxP; i += kF32Threads) {
          const int t = i / kMaxP, j = i % kMaxP;
          xs[i] = (t < kn && j < p) ? xb[(s0 + k0 + t) * sx.s + j] * dtv[k0 + t] : 0.f;
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
          for (int i = 0; i < 4; ++i) av[i] = cs[(ty + 16 * i) * kF32CPitch + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = bt[k * kF32BtPitch + tx + 16 * j];
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
              av[i] = r < n ? bt[r * kF32BtPitch + t] : 0.f;
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
  for (int i = tid; i < n * p; i += kF32Threads) so[i] = st[(i / p) * kMaxP + i % p];
}

template <typename TO>
int launch_f32(const void* x, const void* B, const void* C, const void* dt,
               const void* A, void* y, void* state, int batch, int seqlen,
               int heads, int p, int n, int q, Strides sx, Strides sb, Strides sc,
               Strides sd, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_f32_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = batch * heads;
  if (blocks > 0) {
    ssd_scan_f32_kernel<TO><<<blocks, kF32Threads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(B),
        static_cast<const float*>(C), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<TO*>(y),
        static_cast<float*>(state), heads, seqlen, p, n, q, sx, sb, sc, sd);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: chunk-parallel state passing on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kNPitch = kMaxN + 8;   // bf16 row of a B or C tile, +16 bytes
constexpr int kPPitch = kMaxP + 8;   // bf16 row of an x or state tile, +16 bytes
constexpr int kStateThreads = 128;   // kernel 1: four warps, 32 state rows each
constexpr int kStateStages = 2;      // kernel 1: token tiles in flight (3 and 4
                                     // measured slower: fewer blocks an SM)
constexpr int kPassThreads = 256;    // kernel 2: four state columns a thread
constexpr int kRowBlock = 128;       // kernel 3: query rows a block
constexpr int kOutThreads = 128;     // kernel 3: four warps, two 16-row tiles each

constexpr int kStElems = kMaxN * kMaxP;  // a state in scratch, padded to 128 x 64

constexpr int kBTile = kT * kNPitch;         // elements of a B tile
constexpr int kXTile = kT * kPPitch;         // elements of an x tile
constexpr int kStTile = kMaxN * kPPitch;     // elements of one part of the state

__host__ __device__ constexpr int round_tile(int q) { return (q + kT - 1) / kT * kT; }

// Shared memory of kernels 1 and 3 (ops.py::smem_bytes states the same),
// the chunk's tokens rounded up to whole tiles: kernel 1 its ring of B and x
// tiles and per token cum (fp64) and dt (fp32); kernel 3 a ring of two B and
// x tiles, the entering state's hi and lo parts, cum at each key tile's
// start (fp64) and per token a decay exponent and dt (fp32 each).
size_t state_smem_bytes(int q) {
  return 12 * static_cast<size_t>(round_tile(q)) + 2 * kStateStages * (kBTile + kXTile);
}

size_t out_smem_bytes(int q) {
  return 2 * (2 * kBTile + 2 * kXTile + 2 * kStTile) + 8 * static_cast<size_t>(round_tile(q) / kT) +
         8 * static_cast<size_t>(round_tile(q));
}
static_assert(kRowBlock * kNPitch <= 2 * kBTile, "C's rows pass through the ring");

struct SsdParams {
  const bf16* x;
  const bf16* B;
  const bf16* C;
  const float* dt;
  const float* A;
  void* y;
  float* state_out;   // [b][h][n][p]
  float* states;      // [b][nc][h][kMaxN][kMaxP]: each chunk's state input S_c
  bf16* st_in;        // [b][nc][h][2][kMaxN][kMaxP]: the entering state, hi and lo
  double* cum;        // [b][nc][h][q]
  float* decay;       // [b][nc][h]: exp(cum_end)
  int batch, seqlen, heads, p, n, q, nc;
  Strides sx, sb, sc, sd;
  int vx, vb, vc;     // rows of x, B, C may be copied 16 bytes at a time
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes, global -> shared, bypassing L1; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void store_pair(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                                  uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

// c (16x8, fp32) += a (16x16, bf16, row) * b (16x8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) = hi + lo with hi and lo both bf16 pairs: about 16 bits of each
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A bf16 pair (one fragment register) times two weights, as hi and lo parts
__device__ __forceinline__ void scale_split(uint32_t v, float w0, float w1, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split_bf16(f.x * w0, f.y * w1, hi, lo);
}

// kRows rows of one (batch, head) slice, `width` values each, into a shared
// tile of kW columns at a pitch of kW + 8; zeros past `width` and past row
// `rows` (no padded column is ever NaN).  16-byte cp.async where `vec` (the
// caller commits and waits), else element loads.
template <int kRows, int kW, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t row_stride,
                                          int rows, int width, bool vec) {
  constexpr int kPitch = kW + 8;
  if (vec) {
    constexpr int kChunksRow = kW / 8;
    for (int ch = threadIdx.x; ch < kRows * kChunksRow; ch += kThreads) {
      const int r = ch / kChunksRow, c8 = (ch % kChunksRow) * 8;
      const bool ok = r < rows && c8 < width;
      cp_async16(smem_u32(dst + r * kPitch + c8), ok ? src + r * row_stride + c8 : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kW; e += kThreads) {
      const int r = e / kW, col = e % kW;
      dst[r * kPitch + col] =
          (r < rows && col < width) ? src[r * row_stride + col] : __float2bfloat16(0.f);
    }
  }
}

// Fragment layout of m16n8k16 (lane = 4 g + t): A regs hold rows g / g + 8
// and columns 2t, 2t + 1 / 2t + 8, 2t + 9; B regs hold k = 2t, 2t + 1 /
// 2t + 8, 2t + 9 of column g; C holds rows g (c0, c1) and g + 8 (c2, c3) at
// columns 2t, 2t + 1.  ldmatrix of a stored [k][m] or [k][n] tile takes
// .trans.

// Kernel 1: grid (nc * heads, batch).  Warp w accumulates state rows
// [32 w, 32 w + 32) x 64 columns over the chunk's token tiles: A = B^T
// (ldmatrix.trans of the [token][state] tile), B = x as loaded
// (ldmatrix.trans of [token][p]), each register then scaled by its two
// tokens' dt exp(cum_end - cum) and split into hi and lo parts.  Writes the
// whole padded 128 x 64 state (zeros past n and p).
__global__ void __launch_bounds__(kStateThreads, 3)
ssd_chunk_state_kernel(const SsdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int qr = round_tile(p.q);
  double* cum = reinterpret_cast<double*>(smem_raw);   // [qr]
  bf16* bs = reinterpret_cast<bf16*>(cum + qr);        // [kStateStages][kT][kNPitch]
  bf16* xs = bs + kStateStages * kBTile;               // [kStateStages][kT][kPPitch]
  float* wdt = reinterpret_cast<float*>(xs + kStateStages * kXTile);  // [qr]: dt, then its weight
  __shared__ double warp_tot[kStateThreads / 32];
  __shared__ double carry;

  // kernel 2 may launch once every block of this grid is running
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x / p.heads, hi = blockIdx.x % p.heads, bi = blockIdx.y;
  const int64_t s0 = static_cast<int64_t>(c) * p.q;
  const bf16* xb = p.x + bi * p.sx.b + hi * p.sx.h + s0 * p.sx.s;
  const bf16* bb = p.B + bi * p.sb.b + hi * p.sb.h + s0 * p.sb.s;
  const float* db = p.dt + bi * p.sd.b + hi * p.sd.h + s0 * p.sd.s;
  const int ntiles = qr / kT;

  auto load_tile = [&](int tt, int stage) {
    const int rows = min(kT, p.q - tt * kT);
    load_rows<kT, kMaxN, kStateThreads>(bs + stage * kBTile, bb + tt * kT * p.sb.s, p.sb.s,
                                        rows, p.n, p.vb);
    load_rows<kT, kMaxP, kStateThreads>(xs + stage * kXTile, xb + tt * kT * p.sx.s, p.sx.s,
                                        rows, p.p, p.vx);
  };
#pragma unroll
  for (int st = 0; st < kStateStages - 1; ++st) {
    if (st < ntiles) load_tile(st, st);
    cp_async_commit();
  }

  for (int i = tid; i < qr; i += kStateThreads) wdt[i] = i < p.q ? db[i * p.sd.s] : 0.f;
  chunk_cumsum<kStateThreads>(wdt, cum, p.q, qr, p.A[hi], warp_tot, &carry);
  const double cum_end = cum[p.q - 1];
  const int64_t k = (static_cast<int64_t>(bi) * p.nc + c) * p.heads + hi;
  double* cg = p.cum + k * p.q;
  for (int i = tid; i < p.q; i += kStateThreads) cg[i] = cum[i];
  if (tid == 0) p.decay[k] = expf(static_cast<float>(cum_end));
  // each thread rewrites the entries it scanned: dt -> dt exp(cum_end - cum)
  for (int i = tid; i < qr; i += kStateThreads)
    wdt[i] = i < p.q ? expf(static_cast<float>(cum_end - cum[i])) * wdt[i] : 0.f;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
  const int m0 = warp * 32;

  for (int tt = 0; tt < ntiles; ++tt) {
    cp_async_wait<kStateStages - 2>();
    __syncthreads();  // tile tt (and the weights) are in; the stage refilled next was read
    {
      const int nxt = tt + kStateStages - 1;
      if (nxt < ntiles) load_tile(nxt, nxt % kStateStages);
      cp_async_commit();
    }
    const uint32_t b_s = smem_u32(bs + (tt % kStateStages) * kBTile);
    const uint32_t x_s = smem_u32(xs + (tt % kStateStages) * kXTile);
#pragma unroll
    for (int ks = 0; ks < kT / 16; ++ks) {
      const float* w = wdt + tt * kT + ks * 16 + 2 * t4;
      const float w0 = w[0], w1 = w[1], w8 = w[8], w9 = w[9];
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = ks * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;   // token
        const int col = m0 + mt * 16 + ((lane >> 3) & 1) * 8;          // state
        ldmatrix_x4_trans(b_s + (row * kNPitch + col) * 2, a[mt][0], a[mt][1], a[mt][2], a[mt][3]);
      }
#pragma unroll
      for (int np = 0; np < kMaxP / 16; ++np) {
        const int row = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;   // token
        const int col = np * 16 + (lane >> 4) * 8;                      // p
        uint32_t v0, v1, v2, v3, h0, h1, h2, h3, l0, l1, l2, l3;
        ldmatrix_x4_trans(x_s + (row * kPPitch + col) * 2, v0, v1, v2, v3);
        scale_split(v0, w0, w1, h0, l0);   // tokens 2t, 2t + 1
        scale_split(v1, w8, w9, h1, l1);   // tokens 2t + 8, 2t + 9
        scale_split(v2, w0, w1, h2, l2);
        scale_split(v3, w8, w9, h3, l3);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], h0, h1);
          mma_bf16(acc[mt][2 * np + 1], a[mt], h2, h3);
          mma_bf16(acc[mt][2 * np], a[mt], l0, l1);
          mma_bf16(acc[mt][2 * np + 1], a[mt], l2, l3);
        }
      }
    }
  }

  float* sg = p.states + k * kStElems;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = m0 + mt * 16 + g + 8 * h2, col = nt * 8 + 2 * t4;
        *reinterpret_cast<float2*>(sg + row * kMaxP + col) =
            make_float2(acc[mt][nt][2 * h2], acc[mt][nt][2 * h2 + 1]);
      }
}

// Kernel 2: grid (kMaxN * kMaxP / 4 / 256, batch * heads); a thread carries
// four columns of one state row through the chunks, loading a group of
// chunks' inputs at once.  The scratch was written by kernel 1: it is read
// through L2 (__ldcg), past any stale L1 line.
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(const SsdParams p) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // kernel 1's S_c and decays
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  constexpr int kGroup = 4;
  const int e4 = blockIdx.x * kPassThreads + threadIdx.x;
  const int row = e4 / (kMaxP / 4), col = (e4 % (kMaxP / 4)) * 4;
  const int bi = blockIdx.y / p.heads, hi = blockIdx.y % p.heads;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < p.nc; c0 += kGroup) {
    float4 s[kGroup];
    float d[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (c0 + j >= p.nc) break;
      const int64_t k = (static_cast<int64_t>(bi) * p.nc + c0 + j) * p.heads + hi;
      s[j] = __ldcg(reinterpret_cast<const float4*>(p.states + k * kStElems + row * kMaxP + col));
      d[j] = __ldcg(p.decay + k);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (c0 + j >= p.nc) break;
      const int64_t k = (static_cast<int64_t>(bi) * p.nc + c0 + j) * p.heads + hi;
      uint2 h, l;
      split_bf16(st.x, st.y, h.x, l.x);
      split_bf16(st.z, st.w, h.y, l.y);
      bf16* dst = p.st_in + k * 2 * kStElems + row * kMaxP + col;
      *reinterpret_cast<uint2*>(dst) = h;
      *reinterpret_cast<uint2*>(dst + kStElems) = l;
      st = make_float4(fmaf(st.x, d[j], s[j].x), fmaf(st.y, d[j], s[j].y),
                       fmaf(st.z, d[j], s[j].z), fmaf(st.w, d[j], s[j].w));
    }
  }
  if (row >= p.n) return;
  float* so = p.state_out + (static_cast<int64_t>(bi) * p.heads + hi) * p.n * p.p + row * p.p;
  const float v[4] = {st.x, st.y, st.z, st.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (col + i < p.p) so[col + i] = v[i];
}

// Kernel 3: grid (nc * heads * row blocks of 128, batch); the row blocks of
// a (chunk, head) are adjacent, so they read its entering state and x tiles
// from L2 once, the last row block (the most keys) first.  Warp w owns the 16-row tiles w and
// 7 - w of the block, whose key ranges up to the diagonal are equal in sum
// for every warp.  C's fragments stay in registers (C's rows pass through
// the ring's shared memory first); the entering state (hi and lo) stays in
// shared memory; B and x tiles of 64 keys stream through a ring of two.
// Two blocks share an SM, so one block's loads overlap the other's
// products.  The decay exp(cum_q - cum_t) is taken as exp2 of a row's
// offset from the key tile's start plus the key's (both fp32, from the fp64
// cum), one FADD and one EX2 an element, then times the key's dt.
template <typename TO>
__global__ void __launch_bounds__(kOutThreads, 2)
ssd_chunk_out_kernel(const SsdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr double kLog2e = 1.4426950408889634;
  const int qr = round_tile(p.q);
  bf16* bs = reinterpret_cast<bf16*>(smem_raw);  // [2][kT][kNPitch]; first C [kRowBlock][kNPitch]
  bf16* xs = bs + 2 * kBTile;                    // [2][kT][kPPitch]
  bf16* sh = xs + 2 * kXTile;                    // [kMaxN][kPPitch]
  bf16* sl = sh + kStTile;                       // [kMaxN][kPPitch]
  double* cstart = reinterpret_cast<double*>(sl + kStTile);  // [qr / kT]: cum at a tile's start
  float* ek = reinterpret_cast<float*>(cstart + qr / kT);    // [qr]: (cstart - cum) log2(e)
  float* dk = ek + qr;                                       // [qr]: dt

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row_blocks = (p.q + kRowBlock - 1) / kRowBlock;
  const int chunk_head = blockIdx.x / row_blocks, bi = blockIdx.y;
  const int c = chunk_head / p.heads, hi = chunk_head % p.heads;
  const int r0 = (row_blocks - 1 - blockIdx.x % row_blocks) * kRowBlock;
  const int k_end = min(p.q, r0 + kRowBlock);   // the block reads tokens [0, k_end)
  const int ntiles = (k_end + kT - 1) / kT;
  const int64_t s0 = static_cast<int64_t>(c) * p.q;
  const bf16* xb = p.x + bi * p.sx.b + hi * p.sx.h + s0 * p.sx.s;
  const bf16* bb = p.B + bi * p.sb.b + hi * p.sb.h + s0 * p.sb.s;
  const bf16* cb = p.C + bi * p.sc.b + hi * p.sc.h + s0 * p.sc.s;
  const float* db = p.dt + bi * p.sd.b + hi * p.sd.h + s0 * p.sd.s;
  const int64_t k = (static_cast<int64_t>(bi) * p.nc + c) * p.heads + hi;
  const double* cg = p.cum + k * p.q;

  auto load_keys = [&](int kt, int stage) {
    const int rows = min(kT, p.q - kt * kT);
    load_rows<kT, kMaxN, kOutThreads>(bs + stage * kBTile, bb + kt * kT * p.sb.s, p.sb.s,
                                      rows, p.n, p.vb);
    load_rows<kT, kMaxP, kOutThreads>(xs + stage * kXTile, xb + kt * kT * p.sx.s, p.sx.s,
                                      rows, p.p, p.vx);
  };
  // C first: it does not depend on kernels 1 and 2
  load_rows<kRowBlock, kMaxN, kOutThreads>(bs, cb + r0 * p.sc.s, p.sc.s, k_end - r0, p.n,
                                           p.vc);
  cp_async_commit();

  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // cum and st_in are written
  const bool has_state = c > 0;
  if (has_state) {
    const bf16* src = p.st_in + k * 2 * kStElems;
    constexpr int kChunksRow = kMaxP / 8;
    for (int ch = tid; ch < 2 * kMaxN * kChunksRow; ch += kOutThreads) {
      const int r = ch / kChunksRow, c8 = (ch % kChunksRow) * 8;  // r < 2 kMaxN: hi, then lo
      cp_async16(smem_u32(sh + r * kPPitch + c8), src + r * kMaxP + c8, 16);
    }
  }
  cp_async_commit();
  // a key's factor exp(cstart - cum_t) as an exponent of 2, and its dt
  for (int i = tid; i < k_end; i += kOutThreads) {
    const double c0 = __ldcg(cg + (i & ~(kT - 1)));
    ek[i] = static_cast<float>((c0 - __ldcg(cg + i)) * kLog2e);
    dk[i] = db[i * p.sd.s];
    if ((i & (kT - 1)) == 0) cstart[i / kT] = c0;
  }
  cp_async_wait<0>();
  __syncthreads();

  // this warp's two 16-row tiles (block rows mrow[0] and mrow[1]) and C's
  // A fragments for them
  const int mrow[2] = {16 * warp, 16 * (kRowBlock / 16 - 1 - warp)};
  bool mact[2], rv[2][2];
  int qi[2][2];
  double cq[2][2];
  uint32_t ca[2][kMaxN / 16][4];
  float acc[2][kMaxP / 8][4];
  const uint32_t c_s = smem_u32(bs);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    mact[m] = r0 + mrow[m] < p.q;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      qi[m][h2] = r0 + mrow[m] + g + 8 * h2;
      rv[m][h2] = qi[m][h2] < p.q;
      cq[m][h2] = rv[m][h2] ? __ldcg(cg + qi[m][h2]) : 0.0;
    }
#pragma unroll
    for (int nt = 0; nt < kMaxP / 8; ++nt) acc[m][nt][0] = acc[m][nt][1] = acc[m][nt][2] = acc[m][nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
      const int row = mrow[m] + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int col = ks * 16 + (lane >> 4) * 8;
      if (mact[m])
        ldmatrix_x4(c_s + (row * kNPitch + col) * 2, ca[m][ks][0], ca[m][ks][1], ca[m][ks][2],
                    ca[m][ks][3]);
    }
  }
  __syncthreads();  // C's rows are read: the ring takes key tiles
  load_keys(0, 0);
  cp_async_commit();

  // the entering state's part: exp(cum_q) (C st_in), st_in as hi and lo
  if (has_state) {
    const uint32_t sh_s = smem_u32(sh), sl_s = smem_u32(sl);
#pragma unroll
    for (int ks = 0; ks < kMaxN / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kMaxP / 16; ++np) {
        const int row = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;   // state
        const int col = np * 16 + (lane >> 4) * 8;                      // p
        uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
        ldmatrix_x4_trans(sh_s + (row * kPPitch + col) * 2, h0, h1, h2, h3);
        ldmatrix_x4_trans(sl_s + (row * kPPitch + col) * 2, l0, l1, l2, l3);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (!mact[m]) continue;
          mma_bf16(acc[m][2 * np], ca[m][ks], h0, h1);
          mma_bf16(acc[m][2 * np + 1], ca[m][ks], h2, h3);
          mma_bf16(acc[m][2 * np], ca[m][ks], l0, l1);
          mma_bf16(acc[m][2 * np + 1], ca[m][ks], l2, l3);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float e = rv[m][h2] ? expf(static_cast<float>(cq[m][h2])) : 0.f;
#pragma unroll
        for (int nt = 0; nt < kMaxP / 8; ++nt) {
          acc[m][nt][2 * h2] *= e;
          acc[m][nt][2 * h2 + 1] *= e;
        }
      }
  }

  for (int kt = 0; kt < ntiles; ++kt) {
    // the other stage was read in the previous tile, before its barrier
    if (kt + 1 < ntiles) load_keys(kt + 1, (kt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile is in (the next may still be in flight)
    __syncthreads();
    const int k0 = kt * kT;
    const uint32_t b_s = smem_u32(bs + (kt & 1) * kBTile);
    const uint32_t x_s = smem_u32(xs + (kt & 1) * kXTile);
    // per row tile: the keys of this tile at or before its last row (a
    // multiple of 16), and its rows' decay exponent to the tile's start
    int lim[2];
    float base[2][2];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      lim[m] = mact[m] ? min(kT, r0 + mrow[m] + 16 - k0) : 0;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        base[m][h2] = static_cast<float>((cq[m][h2] - cstart[kt]) * kLog2e);
    }
    // 16 keys at a time: each B and x fragment serves both row tiles (groups
    // of 32 and 64 keys measured slower: more registers live)
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      const bool use[2] = {kk * 16 < lim[0], kk * 16 < lim[1]};
      if (!use[0] && !use[1]) continue;
      // S = C B^T over the 16 keys: two n-tiles of 8 per row tile
      float s[2][2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[m][j][0] = s[m][j][1] = s[m][j][2] = s[m][j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kMaxN / 16; ++ks) {
        const int row = kk * 16 + (lane & 7) + (lane >> 4) * 8;   // key
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;          // state
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(b_s + (row * kNPitch + col) * 2, b0, b1, b2, b3);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (!use[m]) continue;
          mma_bf16(s[m][0], ca[m][ks], b0, b1);
          mma_bf16(s[m][1], ca[m][ks], b2, b3);
        }
      }
      // S o exp(cum_q - cum_t) dt_t in fp32, zero above the diagonal, then
      // re-packed in registers as the A operand, hi and lo parts
      const int kb = k0 + kk * 16 + 2 * t4;
      float2 ekv[2], dkv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        ekv[j] = *reinterpret_cast<const float2*>(ek + kb + 8 * j);
        dkv[j] = *reinterpret_cast<const float2*>(dk + kb + 8 * j);
      }
      uint32_t ph[2][4], pl[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (!use[m]) continue;
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h2 = e >> 1, ti = kb + 8 * j + (e & 1);
            const bool keep = rv[m][h2] && ti <= qi[m][h2];
            const float ekt = (e & 1) ? ekv[j].y : ekv[j].x;
            const float dtt = (e & 1) ? dkv[j].y : dkv[j].x;
            s[m][j][e] = keep ? s[m][j][e] * exp2f(base[m][h2] + ekt) * dtt : 0.f;
          }
        split_bf16(s[m][0][0], s[m][0][1], ph[m][0], pl[m][0]);
        split_bf16(s[m][0][2], s[m][0][3], ph[m][1], pl[m][1]);
        split_bf16(s[m][1][0], s[m][1][1], ph[m][2], pl[m][2]);
        split_bf16(s[m][1][2], s[m][1][3], ph[m][3], pl[m][3]);
      }
      // y += S x
#pragma unroll
      for (int dp = 0; dp < kMaxP / 16; ++dp) {
        const int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;   // key
        const int col = dp * 16 + (lane >> 4) * 8;                      // p
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(x_s + (row * kPPitch + col) * 2, b0, b1, b2, b3);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (!use[m]) continue;
          mma_bf16(acc[m][2 * dp], ph[m], b0, b1);
          mma_bf16(acc[m][2 * dp + 1], ph[m], b2, b3);
          mma_bf16(acc[m][2 * dp], pl[m], b0, b1);
          mma_bf16(acc[m][2 * dp + 1], pl[m], b2, b3);
        }
      }
    }
    __syncthreads();  // this tile's readers are done: its stage may be refilled
  }

  TO* y = static_cast<TO*>(p.y);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (!rv[m][h2]) continue;
      TO* yr = y + ((static_cast<int64_t>(bi) * p.seqlen + s0 + qi[m][h2]) * p.heads + hi) * p.p;
#pragma unroll
      for (int nt = 0; nt < kMaxP / 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        if (col + 1 < p.p && (p.p & 1) == 0) {
          store_pair(yr + col, acc[m][nt][2 * h2], acc[m][nt][2 * h2 + 1]);
        } else {
          if (col < p.p) yr[col] = from_f32<TO>(acc[m][nt][2 * h2]);
          if (col + 1 < p.p) yr[col + 1] = from_f32<TO>(acc[m][nt][2 * h2 + 1]);
        }
      }
    }
}

// Largest dynamic shared memory a block may use on this card (227 KB).
constexpr size_t kMaxSmem = 232448;

template <typename Kernel>
int launch_dependent(Kernel kernel, dim3 grid, int threads, size_t smem,
                     const SsdParams& p, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, p));
  return err != 0 ? err : static_cast<int>(cudaGetLastError());
}

// Raises a kernel's dynamic shared-memory limit to `bytes` where the last
// call left it lower (the limit counts static shared memory beside it, so it
// is set to what the launch needs, not to the card's 227 KB).
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  allowed = bytes;
  return 0;
}

// The bf16 kernels' grids, block sizes and dynamic shared memory
// (ops.py::launch_plan states the same): a block per (chunk, head, batch);
// four state columns a thread over (batch, head); a block per (chunk, head,
// row block, batch), the row blocks of a (chunk, head) adjacent.
struct Bf16Launch {
  dim3 grid[3];
  int threads[3];
  size_t smem[3];
};

Bf16Launch bf16_launch(int batch, int seqlen, int heads, int q) {
  const int nc = seqlen / q, row_blocks = (q + kRowBlock - 1) / kRowBlock;
  return {{dim3(nc * heads, batch), dim3(kStElems / 4 / kPassThreads, batch * heads),
           dim3(nc * heads * row_blocks, batch)},
          {kStateThreads, kPassThreads, kOutThreads},
          {state_smem_bytes(q), 0, out_smem_bytes(q)}};
}

// Raises kernels 1 and 3's dynamic shared-memory limits to what chunk q needs.
template <typename TO>
int allow_bf16_smem(int q) {
  static size_t state_allowed = 0, out_allowed = 0;
  const int err = allow_smem(ssd_chunk_state_kernel, state_smem_bytes(q), state_allowed);
  return err != 0 ? err : allow_smem(ssd_chunk_out_kernel<TO>, out_smem_bytes(q), out_allowed);
}

template <typename TO>
int launch_bf16(const SsdParams& p, int stages, cudaStream_t stream) {
  int err = allow_bf16_smem<TO>(p.q);
  if (err != 0) return err;
  const Bf16Launch l = bf16_launch(p.batch, p.seqlen, p.heads, p.q);
  if (stages & 1) {
    ssd_chunk_state_kernel<<<l.grid[0], l.threads[0], l.smem[0], stream>>>(p);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  if (stages & 2) {
    err = launch_dependent(ssd_state_pass_kernel, l.grid[1], l.threads[1], l.smem[1], p, stream);
    if (err != 0) return err;
  }
  if (stages & 4)
    err = launch_dependent(ssd_chunk_out_kernel<TO>, l.grid[2], l.threads[2], l.smem[2], p,
                           stream);
  return err;
}

// ssd_scan_plan's body: the launch sizes, then the runtime's occupancy of
// each kernel at its block size and dynamic shared memory.
template <typename TO>
int bf16_plan(int batch, int seqlen, int heads, int q, int64_t* out) {
  const int err = allow_bf16_smem<TO>(q);
  if (err != 0) return err;
  const Bf16Launch l = bf16_launch(batch, seqlen, heads, q);
  const void* kernels[3] = {reinterpret_cast<const void*>(ssd_chunk_state_kernel),
                            reinterpret_cast<const void*>(ssd_state_pass_kernel),
                            reinterpret_cast<const void*>(ssd_chunk_out_kernel<TO>)};
  for (int k = 0; k < 3; ++k) {
    int blocks = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernels[k], l.threads[k], l.smem[k]);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int64_t v[5] = {l.grid[k].x, l.grid[k].y, l.threads[k],
                          static_cast<int64_t>(l.smem[k]), blocks};
    for (int i = 0; i < 5; ++i) out[5 * k + i] = v[i];
  }
  return 0;
}

}  // namespace

extern "C" int ssd_scan_fwd(const void* x, const void* B, const void* C,
                            const void* dt, const void* A, void* y,
                            void* state, void* states, void* st_in, void* cum,
                            void* decay,
                            int batch, int seqlen, int heads, int p, int n,
                            int chunk, int64_t xsb, int64_t xss, int64_t xsh,
                            int64_t bsb, int64_t bss, int64_t bsh, int64_t csb,
                            int64_t css, int64_t csh, int64_t dsb, int64_t dss,
                            int64_t dsh, int in_dtype, int out_dtype, int vx,
                            int vb, int vc, int stages, void* stream) {
  if (p < 1 || p > kMaxP || n < 1 || n > kMaxN || chunk < 1 ||
      seqlen % chunk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sx{xsb, xss, xsh}, sb{bsb, bss, bsh}, sc{csb, css, csh},
      sd{dsb, dss, dsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) {
    if (f32_smem_bytes(chunk) > kMaxSmem || stages != 7)
      return static_cast<int>(cudaErrorInvalidValue);
    if (out_dtype == 0)
      return launch_f32<float>(x, B, C, dt, A, y, state, batch, seqlen, heads, p, n,
                               chunk, sx, sb, sc, sd, s);
    if (out_dtype == 1)
      return launch_f32<__nv_bfloat16>(x, B, C, dt, A, y, state, batch, seqlen, heads,
                                       p, n, chunk, sx, sb, sc, sd, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (in_dtype != 1 || out_smem_bytes(chunk) > kMaxSmem || state_smem_bytes(chunk) > kMaxSmem ||
      !states || !st_in || !cum || !decay || stages < 1 || stages > 7)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seqlen == 0 || heads == 0) return 0;
  SsdParams prm;
  prm.x = static_cast<const bf16*>(x);
  prm.B = static_cast<const bf16*>(B);
  prm.C = static_cast<const bf16*>(C);
  prm.dt = static_cast<const float*>(dt);
  prm.A = static_cast<const float*>(A);
  prm.y = y;
  prm.state_out = static_cast<float*>(state);
  prm.states = static_cast<float*>(states);
  prm.st_in = static_cast<bf16*>(st_in);
  prm.cum = static_cast<double*>(cum);
  prm.decay = static_cast<float*>(decay);
  prm.batch = batch;
  prm.seqlen = seqlen;
  prm.heads = heads;
  prm.p = p;
  prm.n = n;
  prm.q = chunk;
  prm.nc = seqlen / chunk;
  prm.sx = sx;
  prm.sb = sb;
  prm.sc = sc;
  prm.sd = sd;
  prm.vx = vx;
  prm.vb = vb;
  prm.vc = vc;
  if (out_dtype == 0) return launch_bf16<float>(prm, stages, s);
  if (out_dtype == 1) return launch_bf16<bf16>(prm, stages, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// For the bf16 kernels at (batch, seqlen, heads, chunk) with y in out_dtype:
// out[5 k .. 5 k + 4] = grid x, grid y, threads, dynamic shared memory and
// the resident blocks an SM that the CUDA runtime reports, for k = 0, 1, 2
// (chunk states, state passing, chunk outputs).
extern "C" int ssd_scan_plan(int batch, int seqlen, int heads, int chunk, int out_dtype,
                             int64_t* out) {
  if (batch < 1 || seqlen < 1 || heads < 1 || chunk < 1 || seqlen % chunk != 0 ||
      out_smem_bytes(chunk) > kMaxSmem || state_smem_bytes(chunk) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == 0) return bf16_plan<float>(batch, seqlen, heads, chunk, out);
  if (out_dtype == 1) return bf16_plan<bf16>(batch, seqlen, heads, chunk, out);
  return static_cast<int>(cudaErrorInvalidValue);
}
