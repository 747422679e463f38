// Dropless MoE experts for Hopper (sm_90a): routing, two grouped GEMMs and the
// combine.
//
// Replaces no TPU kernel: the JAX package's models/moe.py::moe_ffn is plain
// jnp, a one-hot dispatch into capacity slots and einsums over every slot.
// At a capacity no expert can overflow (capacity_factor = E / k, as both MoE
// serve configurations set it) that path computes every token for every
// expert and then masks; these kernels compute the routed (token, choice)
// rows alone, sorted by expert, with no host synchronisation: every grid is
// sized for the worst case and blocks past the routed rows exit at once.
//
// What it computes, for tokens x (T, D), choices expert_idx (T, k) and gates
// (T, k) fp32, experts' weights wg, wu (E, D, F) and wd (E, F, D):
//   route:   counts and offsets of each expert's rows; the row of each (t, j)
//            in the expert-sorted order, stable (token-major, choice-minor:
//            the einsum path's slot order); the token of each row; the table
//            of 64-row tiles (expert, first row), -1 past the last
//   gate/up: h[r] = silu(x[tok[r]] wg[e]) * (x[tok[r]] wu[e])          (N, F)
//   down:    out[r] = h[r] wd[e]                                          (N, D)
//   combine: y[t] = sum_j gate[t, j] out[row(t, j)], fp32 sums, in bf16
// with the einsum path's roundings in bf16: g and u rounded to bf16, silu(g)
// rounded, the product rounded; out rounded; each gate rounded to bf16 before
// the combine (the einsum path casts its combine weights to the compute
// dtype).  Sums run in another order than cuBLAS's.
//
// Bound on this card.  A call reads each routed expert's weights once: 3 x D x
// F bf16 an expert, 1.36 GB a granite layer (72 experts of 4,096 x 768) and
// 4.8 MB a qwen3 expert; the routed rows are few (about 18 an expert at
// granite's decode call, 36 at its 256-token chunk, 4 and 16 at qwen3's), so
// at 2 x rows operations a weight byte the call sits far below the card's
// ~295 operations a byte: weight bytes.  Design: mma.sync m16n8k16 tiles of 64
// rows (a warp-uniform skip of the 16-row slices past an expert's rows, so a
// small expert costs no extra products), 64 (gate/up, both matrices) or 128
// (down) columns, K in steps of 64 through a 4-stage cp.async ring (~18 KB of
// weights a stage, two blocks an SM: ~100 KB in flight on every SM).  A rows
// are gathered by 16-byte cp.async from the token's row of x.  Every weight
// tile is read once for each 64-row tile of its expert; an expert with no rows
// has no tile and reads nothing.  Column tiles run fastest, so the blocks in
// flight together stream whole rows of a few experts' weights (DRAM pages
// read through, not 128 bytes of each), and an expert's row tiles run close
// enough to share its weights in L2.  The kernels take bf16 alone: an fp32
// call on the card keeps moe_ffn's einsum path.
//
// C interface (ctypes): pointers and the stream are void*, every tensor
// contiguous.  moe_route: idx (n = T k) int64 -> row_of (n), src_tok (n),
// offsets (E + 1), tiles (max_tiles, 2), all int32.  moe_expert_gemm: A rows
// (gathered through src_tok, or row r itself where src_tok is null) times
// w0 (and w1: the gate/up form, silu(A w0) * (A w1)) into out (rows, N).
// moe_combine: out (n, D), row_of, gate (T, k) fp32 -> y (T, D).  A choice
// outside [0, E) (an expert another rank holds) has no row (row_of -1) and
// adds nothing to y: routing, tiles and combine skip it.  Activations
// and weights bf16.  Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for shapes it does not take (E > 1024, K, N or D not a
// multiple of 8).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRouteThreads = 1024;
constexpr int kMaxExperts = 1024;
constexpr int kMaxDevices = 64;
constexpr int kBM = 64;          // rows a tile
constexpr int kThreads = 128;    // GEMM: four warps side by side over the columns
constexpr int kBK = 64;
constexpr int kPad = 8;          // row padding: ldmatrix's eight rows in distinct banks

// v rounded to bf16, back in fp32
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// silu as PyTorch's CUDA kernel computes it: x / (1 + exp(-x))
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

// silu(g) * u with the einsum path's roundings in bf16: g and u as the expert
// einsums round them, silu's result, the product (rounded by the store)
__device__ __forceinline__ float swiglu(float g, float u) {
  const float ur = bf16_round(u);
  return __fmul_rn(bf16_round(silu(bf16_round(g))), ur);
}

// ---------------------------------------------------------------------------
// routing: one block

__global__ void __launch_bounds__(kRouteThreads)
route_kernel(const int64_t* __restrict__ idx, int n, int k, int E, int max_tiles,
             int32_t* __restrict__ row_of, int32_t* __restrict__ src_tok,
             int32_t* __restrict__ offsets, int2* __restrict__ tiles) {
  extern __shared__ int smem[];
  int* hist = smem;            // [32 warps][E]: one chunk's choices of each expert by warp
  int* run = smem + 32 * E;    // [E]: choices counted so far, then each expert's offset
  __shared__ int wsum[32], wtile[32], total_tiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < 33 * E; j += kRouteThreads) smem[j] = 0;
  __syncthreads();
  // pass 1: each choice's rank among its expert's choices, in flat order
  for (int base = 0; base < n; base += kRouteThreads) {
    const int i = base + tid;
    int e = -1;
    if (i < n) {
      const int64_t v = idx[i];
      e = v >= 0 && v < E ? static_cast<int>(v) : -1;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (e >= 0 && rank == 0) hist[warp * E + e] = __popc(peers);
    __syncthreads();
    for (int c = tid; c < E; c += kRouteThreads) {
      int s = run[c];
      for (int w = 0; w < 32; ++w) {
        const int v = hist[w * E + c];
        hist[w * E + c] = s;
        s += v;
      }
      run[c] = s;
    }
    __syncthreads();
    if (i < n) row_of[i] = e >= 0 ? hist[warp * E + e] + rank : -1;
    __syncthreads();
    for (int j = tid; j < 32 * E; j += kRouteThreads) hist[j] = 0;
    __syncthreads();
  }
  // offsets and tile offsets: exclusive scans over the experts (E <= 1024)
  const int cnt = tid < E ? run[tid] : 0;
  const int nt = (cnt + kBM - 1) / kBM;
  int ci = cnt, ti = nt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int a = __shfl_up_sync(0xffffffffu, ci, o);
    const int b = __shfl_up_sync(0xffffffffu, ti, o);
    if (lane >= o) {
      ci += a;
      ti += b;
    }
  }
  if (lane == 31) {
    wsum[warp] = ci;
    wtile[warp] = ti;
  }
  __syncthreads();
  if (warp == 0) {
    const int a = wsum[lane], b = wtile[lane];
    int ai = a, bi = b;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, ai, o);
      const int y = __shfl_up_sync(0xffffffffu, bi, o);
      if (lane >= o) {
        ai += x;
        bi += y;
      }
    }
    wsum[lane] = ai - a;
    wtile[lane] = bi - b;
    if (lane == 31) total_tiles = bi;
  }
  __syncthreads();
  const int off = ci - cnt + wsum[warp];
  const int toff = ti - nt + wtile[warp];
  if (tid < E) {
    run[tid] = off;
    offsets[tid] = off;
    if (tid == E - 1) offsets[E] = off + cnt;
  }
  __syncthreads();
  // pass 2: rows (each thread reads back the ranks it wrote), tokens, tiles
  for (int i = tid; i < n; i += kRouteThreads) {
    const int64_t v = idx[i];
    if (v >= 0 && v < E) {
      const int r = run[v] + row_of[i];
      row_of[i] = r;
      src_tok[r] = i / k;
    }
  }
  if (tid < E)
    for (int j = 0; j < nt; ++j) tiles[toff + j] = make_int2(tid, off + j * kBM);
  for (int i = total_tiles + tid; i < max_tiles; i += kRouteThreads) tiles[i] = make_int2(-1, 0);
}

// ---------------------------------------------------------------------------
// grouped GEMM, bf16 on the tensor cores

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

struct GemmArgs {
  const void* a;           // A rows: x (T, K) through src_tok, or h (rows, K)
  const int32_t* src_tok;  // the token of each sorted row; null: row r is row r
  const void* w0;          // (E, K, N)
  const void* w1;          // (E, K, N), the gate/up form's second matrix; or null
  const int32_t* offsets;  // (E + 1)
  const int2* tiles;       // (max_tiles): (expert, first row), expert -1 past the end
  void* out;               // (rows, N)
  int K, N;
};

template <int BN, int NB, int STAGES>
struct Tiling {
  static constexpr int AS = kBK + kPad;          // A's row stride in smem (elements)
  static constexpr int BS = BN + kPad;           // B's
  static constexpr int A_ELEMS = kBM * AS;
  static constexpr int B_ELEMS = kBK * BS;
  static constexpr int STAGE = A_ELEMS + NB * B_ELEMS;
  static constexpr int SMEM = STAGES * STAGE * 2;
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= 228 * 1024 ? 2 : 1;
  static constexpr int WN = BN / 4;              // a warp's columns
  static constexpr int NT = WN / 8;              // its n8 tiles
  static constexpr int MT = kBM / 16;
};

// Fragment layout of m16n8k16 (lane = 4 g + t): A regs hold rows g / g + 8 and
// columns 2t, 2t + 1 / 2t + 8, 2t + 9; B regs hold k = 2t, 2t + 1 / 2t + 8,
// 2t + 9 of column g; C holds rows g (c0, c1) and g + 8 (c2, c3) at columns
// 2t, 2t + 1.
template <int BN, int NB, int STAGES>
__global__ void __launch_bounds__(kThreads, (Tiling<BN, NB, STAGES>::MIN_BLOCKS))
    expert_gemm_kernel(const GemmArgs p) {
  using L = Tiling<BN, NB, STAGES>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int tok[kBM];
  // column tiles fastest: the blocks in flight together read whole rows of
  // an expert's weights, not one narrow column of every expert's
  const int col_tiles = (p.N + BN - 1) / BN;
  const int2 tile = p.tiles[blockIdx.x / col_tiles];
  if (tile.x < 0) return;
  const int e = tile.x, row0 = tile.y;
  const int rows = min(kBM, p.offsets[e + 1] - row0);
  const int live = (rows + 15) >> 4;             // 16-row slices holding rows
  const int n0 = (blockIdx.x % col_tiles) * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = p.K, N = p.N;
  for (int r = tid; r < kBM; r += kThreads)
    tok[r] = r < rows ? (p.src_tok ? p.src_tok[row0 + r] : row0 + r) : -1;
  __syncthreads();
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(p.a);
  const size_t wofs = static_cast<size_t>(e) * K * N;
  const __nv_bfloat16* w[2] = {static_cast<const __nv_bfloat16*>(p.w0) + wofs,
                               NB > 1 ? static_cast<const __nv_bfloat16*>(p.w1) + wofs
                                      : nullptr};
  const uint32_t s0 = smem_u32(smem_raw);
  const int KT = (K + kBK - 1) / kBK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * kBK;
    const uint32_t sa = s0 + stage * L::STAGE * 2;
    // A: the live slices' rows, zeros past the expert's rows
#pragma unroll
    for (int i = 0; i < kBM * 8 / kThreads; ++i) {
      const int c = tid + i * kThreads;
      const int r = c >> 3, ch = c & 7, kk = k0 + ch * 8;
      if (r < live * 16) {
        const int tr = tok[r];
        const bool ok = tr >= 0 && kk < K;
        const __nv_bfloat16* src = ok ? a + static_cast<size_t>(tr) * K + kk : a;
        cp_async16(sa + (r * L::AS + ch * 8) * 2, src, ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      const uint32_t sb = sa + (L::A_ELEMS + m * L::B_ELEMS) * 2;
#pragma unroll
      for (int i = 0; i < kBK * (BN / 8) / kThreads; ++i) {
        const int c = tid + i * kThreads;
        const int kr = c / (BN / 8), ch = c % (BN / 8);
        const int kk = k0 + kr, nn = n0 + ch * 8;
        const bool ok = kk < K && nn < N;
        const __nv_bfloat16* src = ok ? w[m] + static_cast<size_t>(kk) * N + nn : w[m];
        cp_async16(sb + (kr * L::BS + ch * 8) * 2, src, ok ? 16 : 0);
      }
    }
  };

  float acc[NB][L::MT][L::NT][4];
#pragma unroll
  for (int m = 0; m < NB; ++m)
#pragma unroll
    for (int mt = 0; mt < L::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < L::NT; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][mt][nt][c] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();   // tile kt has landed (this thread's part)
    __syncthreads();               // ... every thread's part; stage kt - 1 is free
    {
      const int nxt = kt + STAGES - 1;
      if (nxt < KT) load(nxt % STAGES, nxt);
      cp_async_commit();
    }
    const uint32_t sa = s0 + (kt % STAGES) * L::STAGE * 2;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[L::MT][4];
#pragma unroll
      for (int mt = 0; mt < L::MT; ++mt)
        if (mt < live)
          ldmatrix_x4(sa + ((mt * 16 + (lane & 15)) * L::AS + ks * 16 + (lane >> 4) * 8) * 2,
                      af[mt][0], af[mt][1], af[mt][2], af[mt][3]);
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        const uint32_t sb = sa + (L::A_ELEMS + m * L::B_ELEMS) * 2;
#pragma unroll
        for (int np = 0; np < L::NT / 2; ++np) {
          const int kr = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          const int nc = warp * L::WN + np * 16 + (lane >> 4) * 8;
          uint32_t b0, b1, b2, b3;
          ldmatrix_x4_trans(sb + (kr * L::BS + nc) * 2, b0, b1, b2, b3);
#pragma unroll
          for (int mt = 0; mt < L::MT; ++mt) {
            if (mt < live) {
              mma_bf16(acc[m][mt][2 * np], af[mt], b0, b1);
              mma_bf16(acc[m][mt][2 * np + 1], af[mt], b2, b3);
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < L::MT; ++mt) {
    if (mt >= live) continue;
#pragma unroll
    for (int nt = 0; nt < L::NT; ++nt) {
      const int col = n0 + warp * L::WN + nt * 8 + 2 * t4;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = mt * 16 + g + 8 * h;
        if (r >= rows) continue;
        float v0, v1;
        if (NB == 2) {
          v0 = swiglu(acc[0][mt][nt][2 * h], acc[NB - 1][mt][nt][2 * h]);
          v1 = swiglu(acc[0][mt][nt][2 * h + 1], acc[NB - 1][mt][nt][2 * h + 1]);
        } else {
          v0 = acc[0][mt][nt][2 * h];
          v1 = acc[0][mt][nt][2 * h + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(row0 + r) * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// combine: one block a token, 16 bytes a thread a step, no atomics

__global__ void __launch_bounds__(256) combine_kernel(const __nv_bfloat16* __restrict__ out,
                                                      const int32_t* __restrict__ row_of,
                                                      const float* __restrict__ gate,
                                                      __nv_bfloat16* __restrict__ y, int k, int D) {
  constexpr int V = 8;
  const int t = blockIdx.x;
  for (int c = threadIdx.x; c < D / V; c += blockDim.x) {
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.f;
    for (int j = 0; j < k; ++j) {
      const int r = row_of[static_cast<size_t>(t) * k + j];
      if (r < 0) continue;  // a choice of an expert this rank does not hold
      const float gj = bf16_round(gate[static_cast<size_t>(t) * k + j]);
      const uint4 raw = *reinterpret_cast<const uint4*>(out + static_cast<size_t>(r) * D + c * V);
      const __nv_bfloat16* v = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = fmaf(gj, __bfloat162float(v[q]), acc[q]);
    }
    uint4 res;
    __nv_bfloat16* rv = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
    for (int q = 0; q < V; ++q) rv[q] = __float2bfloat16(acc[q]);
    *reinterpret_cast<uint4*>(y + static_cast<size_t>(t) * D + c * V) = res;
  }
}

// the dynamic shared memory a kernel may take, raised once a device
template <typename Kern>
cudaError_t allow_smem(Kern kern, int bytes, int (&allowed)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes > allowed[dev]) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    allowed[dev] = bytes;
  }
  return cudaSuccess;
}

template <int BN, int NB, int STAGES>
int launch_gemm(const GemmArgs& p, int max_tiles, cudaStream_t s) {
  static int allowed[kMaxDevices];
  constexpr int smem = Tiling<BN, NB, STAGES>::SMEM;
  const cudaError_t err = allow_smem(expert_gemm_kernel<BN, NB, STAGES>, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = static_cast<int64_t>(max_tiles) * ((p.N + BN - 1) / BN);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  expert_gemm_kernel<BN, NB, STAGES><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int moe_route(const void* idx, int n, int k, int E, int max_tiles, void* row_of,
                         void* src_tok, void* offsets, void* tiles, void* stream) {
  if (n < 0 || k < 1 || E < 1 || E > kMaxExperts || max_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  static int allowed[kMaxDevices];
  const int smem = 33 * E * static_cast<int>(sizeof(int));
  const cudaError_t err = allow_smem(route_kernel, smem, allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  route_kernel<<<1, kRouteThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(idx), n, k, E, max_tiles, static_cast<int32_t*>(row_of),
      static_cast<int32_t*>(src_tok), static_cast<int32_t*>(offsets),
      static_cast<int2*>(tiles));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int moe_expert_gemm(const void* a, const void* src_tok, const void* w0,
                               const void* w1, const void* offsets, const void* tiles,
                               void* out, int max_tiles, int K, int N, void* stream) {
  if (K < 1 || N < 1 || K % 8 || N % 8 || max_tiles < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_tiles == 0) return 0;
  const GemmArgs p{a, static_cast<const int32_t*>(src_tok), w0, w1,
                   static_cast<const int32_t*>(offsets), static_cast<const int2*>(tiles),
                   out, K, N};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return w1 ? launch_gemm<64, 2, 4>(p, max_tiles, s) : launch_gemm<128, 1, 4>(p, max_tiles, s);
}

extern "C" int moe_combine(const void* out, const void* row_of, const void* gate, void* y,
                           int T, int k, int D, void* stream) {
  if (T < 0 || k < 1 || D < 1 || D % 8) return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  const int threads = D / 8 < 256 ? ((D / 8 + 31) / 32) * 32 : 256;
  combine_kernel<<<T, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(out), static_cast<const int32_t*>(row_of),
      static_cast<const float*>(gate), static_cast<__nv_bfloat16*>(y), k, D);
  return static_cast<int>(cudaGetLastError());
}
