// Flash-attention backward for Hopper (sm_90a): the gradient of the bf16
// forward in flash_attention.cu in q, k and v, in two kernels.
//
// Replaces no TPU kernel.  The JAX package has no backward kernel: its
// custom_vjp recomputes attention_ref and differentiates it, as the port's
// ops.py::_backward still does for fp32 and CPU tensors.  This kernel was
// added because on the H100 that plain VJP took 2.29 s of the 4.09 s train
// step of seamless-m4t-large-v2 (batch 8 of 2048, 144 backward calls a step):
// fp32 (B, H, Sq, Skv) scores, 1.07 GB a tensor, materialised several times
// and differentiated on CUDA cores, 110 times the least time of that work on
// the tensor cores.
//
// What it computes, for query row i (batch b, head h) that sees the keys
// j < lim(i) of the forward's masks, with s_j = sm_scale q_i . k_j:
//   LSE = log sum_j exp(s_j),  P_j = exp(s_j - LSE),  dP_j = do_i . v_j,
//   D = sum_j P_j dP_j,  dS_j = P_j (dP_j - D),
//   dq_i = sm_scale sum_j dS_j k_j,  dk_j += sm_scale dS_j q_i,
//   dv_j += P_j do_i,
// dk and dv summed over every row of every head of the GQA group.  A row
// that sees no key has P = 0: it adds nothing and its dq is zero.
// kernels/flash_attention/ref.py::attention_bwd_ref is the plain version.
//
// What bounds it: operations.  The least work is five products of the
// scores' size (S, dP, dq, dk, dv), 2.5 times the forward's two; the bytes
// (q, k, v, do in, dq, dk, dv out) are a few MB a call.  This design does 12
// such products counting recomputation and the split parts below: 2 for the
// row statistics, 4 for dq, 6 for dk and dv.
//
// Design:
//   * flash_bwd_dq_kernel: one block per (64 packed rows, batch * KV head),
//     a row packed as in the forward (query position, one of the heads that
//     share the KV head), four warps of 16 rows.  Q's and dO's A fragments
//     stay in registers.  Two sweeps over the key tiles, each through a
//     cp.async ring of K and V tiles.  The first computes S = Q K^T and
//     dP = dO V^T and, by an online softmax on the fragments, each row's LSE
//     and D = sum P dP, and writes both to fp32 scratch (one entry a packed
//     row, padded to 64 rows a (batch, KV head); the wrapper allocates it).
//     The second recomputes S and dP, forms dS and accumulates dq += dS K.
//     D is sum P dP, as the plain VJP's softmax backward takes it, and not
//     rowsum(do * o) from the forward's bf16 output: that rounding of o
//     moved bf16 dq and dk past the 4e-3 check by up to 2.9 times the limit
//     at causal rows that see few keys (ref.py, emulated on the CPU).
//   * flash_bwd_dkdv_kernel: one block per (64 keys, batch * KV head), four
//     warps of 16 keys.  K and V stay in shared memory; the packed rows of
//     every head of the group stream through a ring of Q, dO, LSE and D
//     tiles, so the group's dk and dv are summed in the block's registers.
//     Per tile S^T = K Q^T and dP^T = V dO^T, P^T and dS^T on the fragments,
//     dv += P^T dO and dk += dS^T Q.  Causal: row tiles that see none of the
//     block's keys are skipped.
//   * The tiles adapt to the head dim: the dq kernel's key tiles and the
//     dK/dV kernel's row tiles are 64, or 32 at D = 128, so a thread holds
//     tile + D accumulator and fragment registers (ops.py backward_plan).
//   * mma.sync.m16n8k16, bf16 operands, fp32 accumulators.  q, k, v and do
//     enter as they are; P and dS enter as bf16 high and low parts (two
//     products each, ~16 bits), as the forward's P does: the plain VJP is
//     fp32, and one rounding of P and dS to bf16 moved dk and dv to 2.5
//     times the check's limit (emulated on the CPU), the split to 0.83.
//   * Masks on edge tiles only, as in the forward; keys at or past kv_len
//     are zero-filled.
//   * No atomics: each element of dq, dk and dv is summed by one thread in a
//     fixed order, so a call gives the same bits every run.  The price is
//     the dq kernel recomputing S and dP apart from the dK/dV kernel.
//
// C interface (ctypes): every pointer and the stream are void*; q_offset and
// kv_len are int32 device arrays of B entries or null; every tensor is bf16
// and contiguous (q, do, dq (B, Sq, H, D); k, v, dk, dv (B, Skv, K, D));
// scratch holds 2 * B * K * rows_pad floats, rows_pad the packed rows
// Sq * H / K rounded up to 64 (the wrapper's plan).  Returns
// cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// the LSE of a row that sees no key (and of the padding): exp2(x - LSE) = 0
constexpr float kEmptyLse = 1e30f;
constexpr int kThreads = 128;   // four warps
constexpr int kRowsDq = 64;     // packed rows a dq block; the scratch's padding (ops.py BWD_BLOCK_M)
constexpr int kKeysDkdv = 64;   // keys a dK/dV block (ops.py BWD_KEYS)
constexpr int kStages = 2;      // cp.async ring (ops.py BWD_STAGES)
constexpr int kPad = 8;         // bf16 padding per shared-memory row (16 bytes)

// the dq kernel's key tile and the dK/dV kernel's row tile (ops.py bwd_tile)
template <int D>
__host__ __device__ constexpr int tile_of() { return D <= 64 ? 64 : 32; }

template <int D>
__host__ __device__ constexpr int dq_smem_bytes() {
  return kStages * 2 * tile_of<D>() * (D + kPad) * 2;
}

template <int D>
__host__ __device__ constexpr int dkdv_stage_bytes() {
  return 2 * tile_of<D>() * (D + kPad) * 2 + 2 * tile_of<D>() * 4;
}

template <int D>
__host__ __device__ constexpr int dkdv_smem_bytes() {
  return 2 * kKeysDkdv * (D + kPad) * 2 + kStages * dkdv_stage_bytes<D>();
}

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* lse;    // [B * K][rows_pad]: each packed row's LSE, log2 domain
  float* dsum;   // [B * K][rows_pad]: each packed row's D
  const int* q_offset;
  const int* kv_len;
  int sq, skv, heads, kv_heads, group, rows, rows_pad, causal;
  float scale;
};

// -- the forward's fragment helpers (flash_attention.cu) ----------------------

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) = hi + lo with hi and lo both bf16 pairs: about 16 bits of each
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// -- shared pieces of the two kernels -----------------------------------------

// the row of q, do and dq that packed row pr of (batch b, KV head kh) is
__device__ __forceinline__ int64_t global_row(const BwdParams& p, int b, int kh, int pr) {
  const int qi = pr / p.group, gg = pr % p.group;
  return (static_cast<int64_t>(b) * p.sq + qi) * p.heads + kh * p.group + gg;
}

// packed row pr sees the keys j < row_limit (none past the rows)
__device__ __forceinline__ int row_limit(const BwdParams& p, int pr, int qoff, int kvl) {
  if (pr >= p.rows) return 0;
  return p.causal ? min(kvl, max(qoff + pr / p.group + 1, 0)) : kvl;
}

// Fragment layout of m16n8k16 (lane = 4 g + t): A regs hold rows g / g + 8
// and columns 2t, 2t + 1 / 2t + 8, 2t + 9; B regs hold k = 2t, 2t + 1 /
// 2t + 8, 2t + 9 of column g; C holds rows g (c0, c1) and g + 8 (c2, c3) at
// columns 2t, 2t + 1.

// A fragments of rows r[0] (g) and r[1] (g + 8) of a (., D) bf16 matrix,
// zeros where the row is not valid
template <int D>
__device__ __forceinline__ void load_a_rows(const bf16* base, const bool (&valid)[2],
                                            const int64_t (&row)[2], int tig,
                                            uint32_t (&a)[D / 16][4]) {
  const bf16* r0 = base + (valid[0] ? row[0] : 0) * D;
  const bf16* r1 = base + (valid[1] ? row[1] : 0) * D;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * tig;
    a[ks][0] = valid[0] ? ld_u32(r0 + c) : 0u;
    a[ks][1] = valid[1] ? ld_u32(r1 + c) : 0u;
    a[ks][2] = valid[0] ? ld_u32(r0 + c + 8) : 0u;
    a[ks][3] = valid[1] ? ld_u32(r1 + c + 8) : 0u;
  }
}

// acc (16 x 8 kNT) += A (16 x D) B^T, B the first 8 kNT rows of a
// shared-memory tile (row-major, D wide, padded rows at b_s); A given in
// registers
template <int D, int kNT>
__device__ __forceinline__ void mma_a_bt(float (&acc)[kNT][4], const uint32_t (&a)[D / 16][4],
                                         uint32_t b_s, int lane) {
  constexpr int kStride = D + kPad;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
      const int c = ks * 16 + ((lane >> 3) & 1) * 8;
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b_s + (r * kStride + c) * 2, b0, b1, b2, b3);
      mma_bf16(acc[2 * np], a[ks], b0, b1);
      mma_bf16(acc[2 * np + 1], a[ks], b2, b3);
    }
  }
}

// the same with A the 16 rows of a shared-memory tile at a_s
template <int D, int kNT>
__device__ __forceinline__ void mma_as_bt(float (&acc)[kNT][4], uint32_t a_s, uint32_t b_s,
                                          int lane) {
  constexpr int kStride = D + kPad;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    const int ar = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int ac = ks * 16 + (lane >> 4) * 8;
    ldmatrix_x4(a_s + (ar * kStride + ac) * 2, a[0], a[1], a[2], a[3]);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      const int r = np * 16 + (lane & 7) + (lane >> 4) * 8;
      const int c = ks * 16 + ((lane >> 3) & 1) * 8;
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4(b_s + (r * kStride + c) * 2, b0, b1, b2, b3);
      mma_bf16(acc[2 * np], a, b0, b1);
      mma_bf16(acc[2 * np + 1], a, b2, b3);
    }
  }
}

// acc (16 x D) += X B, X (16 x 8 kNT) the fp32 fragments of an earlier
// product, re-packed in registers as the A operand in bf16 high and low
// parts (two products, ~16 bits), B the first 8 kNT rows of a shared-memory
// tile (read transposed)
template <int D, int kNT>
__device__ __forceinline__ void mma_x_b(float (&acc)[D / 8][4], const float (&x)[kNT][4],
                                        uint32_t b_s, int lane) {
  constexpr int kStride = D + kPad;
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    uint32_t xh[4], xl[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], xh[0], xl[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], xh[1], xl[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], xh[2], xl[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], xh[3], xl[3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = dp * 16 + (lane >> 4) * 8;
      uint32_t b0, b1, b2, b3;
      ldmatrix_x4_trans(b_s + (r * kStride + c) * 2, b0, b1, b2, b3);
      mma_bf16(acc[2 * dp], xh, b0, b1);
      mma_bf16(acc[2 * dp + 1], xh, b2, b3);
      mma_bf16(acc[2 * dp], xl, b0, b1);
      mma_bf16(acc[2 * dp + 1], xl, b2, b3);
    }
  }
}

// -- dq, with the row statistics as its first sweep ----------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int kKeys = tile_of<D>();     // keys a tile
  constexpr int kNT = kKeys / 8;          // score n-tiles a warp
  constexpr int kDT = D / 8;              // dq n-tiles
  constexpr int kStride = D + kPad;
  constexpr int kChunksRow = D / 8;       // 16-byte chunks a K/V row
  constexpr int kChunks = kKeys * kChunksRow;
  constexpr int kTileBytes = kKeys * kStride * 2;
  static_assert(kChunks % kThreads == 0, "tile chunks per thread");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t k_s0 = smem_u32(smem_raw);
  const uint32_t v_s0 = k_s0 + kStages * kTileBytes;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int tile_r0 = blockIdx.x * kRowsDq;
  const int bk = blockIdx.y;
  const int b = bk / p.kv_heads, kh = bk % p.kv_heads;

  const int qoff = p.q_offset ? p.q_offset[b] : 0;
  int kvl = p.kv_len ? p.kv_len[b] : p.skv;
  kvl = min(max(kvl, 0), p.skv);
  // the grid covers rows_pad / 64 tiles, each holding at least one row
  const int rows_here = min(kRowsDq, p.rows - tile_r0);
  // n_keys: keys any row of the block sees; full_keys: keys every row sees
  int n_keys = kvl, full_keys = kvl;
  if (p.causal) {
    const int q_first = tile_r0 / p.group, q_last = (tile_r0 + rows_here - 1) / p.group;
    n_keys = min(kvl, max(qoff + q_last + 1, 0));
    full_keys = min(kvl, max(qoff + q_first + 1, 0));
  }
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;

  // this lane's two rows (g and g + 8 of the warp's 16)
  const int wr0 = warp * 16;
  const bool warp_active = tile_r0 + wr0 < p.rows;
  bool valid[2];
  int lim[2];
  int64_t grow[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int pr = tile_r0 + wr0 + g + 8 * h2;
    valid[h2] = pr < p.rows;
    grow[h2] = valid[h2] ? global_row(p, b, kh, pr) : 0;
    lim[h2] = row_limit(p, pr, qoff, kvl);
  }

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_a_rows<D>(p.q, valid, grow, tig, qa);
  load_a_rows<D>(p.dout, valid, grow, tig, da);

  const int64_t kv_row = static_cast<int64_t>(p.kv_heads) * D;  // elements between keys
  const bf16* kbase = p.k + (static_cast<int64_t>(b) * p.skv * p.kv_heads + kh) * D;
  const bf16* vbase = p.v + (static_cast<int64_t>(b) * p.skv * p.kv_heads + kh) * D;

  auto load_tile = [&](int tile, int stage) {
    const int key0 = tile * kKeys;
#pragma unroll
    for (int i = 0; i < kChunks / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kChunksRow, ch = c % kChunksRow;
      const int key = key0 + r;
      const bool ok = key < n_keys;
      const int64_t off = (ok ? key : 0) * kv_row + ch * 8;
      const uint32_t so = static_cast<uint32_t>(stage * kTileBytes + (r * kStride + ch * 8) * 2);
      cp_async16(k_s0 + so, kbase + off, ok ? 16 : 0);
      cp_async16(v_s0 + so, vbase + off, ok ? 16 : 0);
    }
  };

  float lse[2] = {kEmptyLse, kEmptyLse}, dd[2] = {0.f, 0.f};
  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  // sweep 0: LSE and D by an online softmax; sweep 1: dq
  for (int sweep = 0; sweep < 2; ++sweep) {
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < n_tiles) load_tile(s, s);
      cp_async_commit();
    }
    for (int it = 0; it < n_tiles; ++it) {
      cp_async_wait<kStages - 2>();  // tile `it` has landed (this thread's part)
      __syncthreads();               // ... every thread's part; stage it-1 is free
      {
        const int nxt = it + kStages - 1;
        if (nxt < n_tiles) load_tile(nxt, nxt % kStages);
        cp_async_commit();
      }
      if (!warp_active) continue;
      const int stage = it % kStages;
      const uint32_t ks_base = k_s0 + stage * kTileBytes;
      const uint32_t vs_base = v_s0 + stage * kTileBytes;

      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
        dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
      }
      mma_a_bt<D, kNT>(s, qa, ks_base, lane);   // S = Q K^T
      mma_a_bt<D, kNT>(dp, da, vs_base, lane);  // dP = dO V^T

      // the scaled fp32 scores; masked on edge tiles only
      const bool edge = it * kKeys + kKeys > full_keys;
      const int key_base = it * kKeys + 2 * tig;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[nt][c] * p.scale;
          if (edge && key_base + nt * 8 + (c & 1) >= lim[c >> 1]) x = kNegInf;
          s[nt][c] = x;
        }
      }

      if (sweep == 0) {
        // online softmax on the fragments (a row lives on the four lanes of
        // a quad), D carried beside l
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          float mx = m[h2];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * h2], s[nt][2 * h2 + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // a row with nothing visible yet: base 0, so p = exp(-1e30) = 0
          const float base = mx > kNegInf * 0.5f ? mx * kLog2e : 0.f;
          const float corr = exp2f(m[h2] * kLog2e - base);
          m[h2] = mx;
          float sum = 0.f, dsp = 0.f;
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const float e0 = exp2f(s[nt][2 * h2] * kLog2e - base);
            const float e1 = exp2f(s[nt][2 * h2 + 1] * kLog2e - base);
            sum += e0 + e1;
            dsp += e0 * dp[nt][2 * h2] + e1 * dp[nt][2 * h2 + 1];
          }
          l[h2] = l[h2] * corr + sum;  // this lane's part; the quad sums at the end
          ds[h2] = ds[h2] * corr + dsp;
        }
      } else {
        // dS = P (dP - D), then dq += dS K
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float pv = exp2f(s[nt][c] * kLog2e - lse[c >> 1]);
            s[nt][c] = pv * (dp[nt][c] - dd[c >> 1]);
          }
        }
        mma_x_b<D, kNT>(acc, s, ks_base, lane);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is free for the next sweep

    if (sweep == 0) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
        l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
        ds[h2] += __shfl_xor_sync(0xffffffffu, ds[h2], 1);
        ds[h2] += __shfl_xor_sync(0xffffffffu, ds[h2], 2);
        const bool seen = valid[h2] && l[h2] > 0.f;
        lse[h2] = seen ? m[h2] * kLog2e + log2f(l[h2]) : kEmptyLse;
        dd[h2] = seen ? ds[h2] / l[h2] : 0.f;
        // every row of the tile, the padding included
        if (tig == 0) {
          const int64_t at = static_cast<int64_t>(bk) * p.rows_pad + tile_r0 + wr0 + g + 8 * h2;
          p.lse[at] = lse[h2];
          p.dsum[at] = dd[h2];
        }
      }
    }
  }

  if (!warp_active) return;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    if (!valid[h2]) continue;
    bf16* dq_p = p.dq + grow[h2] * D + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(dq_p + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * h2] * p.scale, acc[dt][2 * h2 + 1] * p.scale);
  }
}

// -- dk and dv ----------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int kRows = tile_of<D>();     // packed rows a tile
  constexpr int kNT = kRows / 8;          // score n-tiles a warp
  constexpr int kDT = D / 8;              // dk / dv n-tiles
  constexpr int kStride = D + kPad;
  constexpr int kChunksRow = D / 8;
  constexpr int kKvChunks = kKeysDkdv * kChunksRow;
  constexpr int kRowChunks = kRows * kChunksRow;
  constexpr int kMatBytes = kRows * kStride * 2;     // a Q or dO tile
  constexpr int kStageBytes = dkdv_stage_bytes<D>();
  static_assert(kKvChunks % kThreads == 0 && kRowChunks % kThreads == 0, "chunks per thread");
  static_assert(kRows / 2 <= kThreads, "a thread a 16-byte chunk of LSE or D");
  static_assert(kStageBytes == 2 * kMatBytes + 2 * kRows * 4, "stage layout");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t k_s = smem_u32(smem_raw);
  const uint32_t v_s = k_s + kKeysDkdv * kStride * 2;
  // stage s: Q [kRows][kStride], dO [kRows][kStride], LSE [kRows], D [kRows]
  const int ring_off = 2 * kKeysDkdv * kStride * 2;
  const uint32_t ring = k_s + ring_off;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int key0 = blockIdx.x * kKeysDkdv;
  const int bk = blockIdx.y;
  const int b = bk / p.kv_heads, kh = bk % p.kv_heads;
  const int kw = warp * 16;  // this warp's 16 keys of the block

  const int qoff = p.q_offset ? p.q_offset[b] : 0;
  int kvl = p.kv_len ? p.kv_len[b] : p.skv;
  kvl = min(max(kvl, 0), p.skv);

  // causal: the rows before the first one that sees key0 see none of the
  // block's keys; past kv_len no row sees any
  const int n_row_tiles = (p.rows + kRows - 1) / kRows;
  int first = 0;
  if (p.causal) {
    const int64_t r = static_cast<int64_t>(max(key0 - qoff, 0)) * p.group / kRows;
    first = r < n_row_tiles ? static_cast<int>(r) : n_row_tiles;
  }
  const int my_tiles = key0 < kvl ? n_row_tiles - first : 0;
  // every key of the block is visible to every row of a tile that starts
  // at row r0 unless the block crosses kv_len or, causal, the diagonal
  const bool kv_edge = key0 + kKeysDkdv > kvl;

  float adk[kDT][4], adv[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) {
    adk[i][0] = adk[i][1] = adk[i][2] = adk[i][3] = 0.f;
    adv[i][0] = adv[i][1] = adv[i][2] = adv[i][3] = 0.f;
  }

  const int64_t kv_row = static_cast<int64_t>(p.kv_heads) * D;
  const bf16* kbase = p.k + (static_cast<int64_t>(b) * p.skv * p.kv_heads + kh) * D;
  const bf16* vbase = p.v + (static_cast<int64_t>(b) * p.skv * p.kv_heads + kh) * D;
  const float* lse_g = p.lse + static_cast<int64_t>(bk) * p.rows_pad;
  const float* ds_g = p.dsum + static_cast<int64_t>(bk) * p.rows_pad;

  auto load_rows = [&](int tile, int stage) {
    const int r0 = tile * kRows;
    const uint32_t st = ring + stage * kStageBytes;
#pragma unroll
    for (int i = 0; i < kRowChunks / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kChunksRow, ch = c % kChunksRow;
      const int pr = r0 + r;
      const bool ok = pr < p.rows;
      const int64_t off = (ok ? global_row(p, b, kh, pr) : 0) * D + ch * 8;
      const uint32_t so = static_cast<uint32_t>((r * kStride + ch * 8) * 2);
      cp_async16(st + so, p.q + off, ok ? 16 : 0);
      cp_async16(st + kMatBytes + so, p.dout + off, ok ? 16 : 0);
    }
    // the tile's LSE and D: 16 bytes a thread (inside the padded scratch)
    const int t = threadIdx.x;
    if (t < kRows / 4)
      cp_async16(st + 2 * kMatBytes + t * 16, lse_g + r0 + 4 * t, 16);
    else if (t < kRows / 2)
      cp_async16(st + 2 * kMatBytes + kRows * 4 + (t - kRows / 4) * 16,
                 ds_g + r0 + 4 * (t - kRows / 4), 16);
  };

  if (my_tiles > 0) {
    // the block's K and V (zeros at and past kv_len), in the first group
#pragma unroll
    for (int i = 0; i < kKvChunks / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kChunksRow, ch = c % kChunksRow;
      const int key = key0 + r;
      const bool ok = key < kvl;
      const int64_t off = (ok ? key : 0) * kv_row + ch * 8;
      const uint32_t so = static_cast<uint32_t>((r * kStride + ch * 8) * 2);
      cp_async16(k_s + so, kbase + off, ok ? 16 : 0);
      cp_async16(v_s + so, vbase + off, ok ? 16 : 0);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < my_tiles) load_rows(first + s, s);
    cp_async_commit();
  }

  for (int it = 0; it < my_tiles; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int nxt = it + kStages - 1;
      if (nxt < my_tiles) load_rows(first + nxt, nxt % kStages);
      cp_async_commit();
    }
    const int r0 = (first + it) * kRows;
    const int stage = it % kStages;
    const uint32_t q_t = ring + stage * kStageBytes;
    const uint32_t do_t = q_t + kMatBytes;
    const float* lse_t = reinterpret_cast<const float*>(
        smem_raw + ring_off + stage * kStageBytes + 2 * kMatBytes);
    const float* dd_t = lse_t + kRows;

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
    mma_as_bt<D, kNT>(s, k_s + kw * kStride * 2, q_t, lane);    // S^T = K Q^T
    mma_as_bt<D, kNT>(dp, v_s + kw * kStride * 2, do_t, lane);  // dP^T = V dO^T

    const bool edge = kv_edge || (p.causal && qoff + r0 / p.group < key0 + kKeysDkdv - 1);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = nt * 8 + 2 * tig;  // the tile's packed rows col, col + 1
      const float2 lv = *reinterpret_cast<const float2*>(lse_t + col);
      const float2 dv2 = *reinterpret_cast<const float2*>(dd_t + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float lse_c = (c & 1) ? lv.y : lv.x;
        const float d_c = (c & 1) ? dv2.y : dv2.x;
        float pv = exp2f(s[nt][c] * p.scale * kLog2e - lse_c);
        if (edge && key0 + kw + g + 8 * (c >> 1) >= row_limit(p, r0 + col + (c & 1), qoff, kvl))
          pv = 0.f;
        s[nt][c] = pv;                       // P^T
        dp[nt][c] = pv * (dp[nt][c] - d_c);  // dS^T
      }
    }
    mma_x_b<D, kNT>(adv, s, do_t, lane);  // dv += P^T dO
    mma_x_b<D, kNT>(adk, dp, q_t, lane);  // dk += dS^T Q
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int key = key0 + kw + g + 8 * h2;
    if (key >= p.skv) continue;
    const int64_t off = ((static_cast<int64_t>(b) * p.skv + key) * p.kv_heads + kh) * D + 2 * tig;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off + dt * 8) =
          __floats2bfloat162_rn(adk[dt][2 * h2] * p.scale, adk[dt][2 * h2 + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off + dt * 8) =
          __floats2bfloat162_rn(adv[dt][2 * h2], adv[dt][2 * h2 + 1]);
    }
  }
}

template <int D>
int launch_bwd(const BwdParams& p, int batch, cudaStream_t stream) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dq_smem_bytes<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem_bytes<D>());
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const unsigned bk = static_cast<unsigned>(batch * p.kv_heads);
  flash_bwd_dq_kernel<D><<<dim3(static_cast<unsigned>(p.rows_pad / kRowsDq), bk), kThreads,
                           dq_smem_bytes<D>(), stream>>>(p);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const unsigned key_tiles = static_cast<unsigned>((p.skv + kKeysDkdv - 1) / kKeysDkdv);
  if (key_tiles > 0)
    flash_bwd_dkdv_kernel<D><<<dim3(key_tiles, bk), kThreads, dkdv_smem_bytes<D>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, void* dq, void* dk, void* dv,
                                   const void* q_offset, const void* kv_len, void* scratch,
                                   int batch, int sq, int skv, int heads, int kv_heads, int d,
                                   int causal, float scale, int rows_pad, void* stream) {
  if (batch <= 0 || sq <= 0 || skv < 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.q_offset = static_cast<const int*>(q_offset);
  p.kv_len = static_cast<const int*>(kv_len);
  p.sq = sq;
  p.skv = skv;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.group = heads / kv_heads;
  p.rows = sq * p.group;
  p.rows_pad = rows_pad;
  p.causal = causal;
  p.scale = scale;
  if (scratch == nullptr || rows_pad < p.rows || rows_pad % kRowsDq)
    return static_cast<int>(cudaErrorInvalidValue);
  p.lse = static_cast<float*>(scratch);
  p.dsum = p.lse + static_cast<int64_t>(batch) * kv_heads * rows_pad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch_bwd<32>(p, batch, s);
    case 64: return launch_bwd<64>(p, batch, s);
    case 128: return launch_bwd<128>(p, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
