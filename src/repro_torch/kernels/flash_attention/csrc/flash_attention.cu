// Flash-attention forward for Hopper (sm_90a), online softmax, native GQA.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd -> _flash_fwd_kernel).
//
// What it computes, as the TPU kernel does: for query row i of batch b and
// head h, softmax(sm_scale * q k^T) v over the keys j of KV head h / (H/K)
// with j < kv_len[b] and, when causal, j <= q_offset[b] + i.  sm_scale is
// applied to the fp32 scores after the product; masked scores are -1e30 (they
// add exactly zero); m, l and the accumulator are fp32; a row with no visible
// key is written as zeros; the output has q's dtype.  With q_offset = 0 and a
// uniform kv_len this is the TPU kernel's mask (top-left causal,
// k_pos < kv_valid); with the paged serve values it is the engine's
// absolute-position mask.
//
// Two bodies, chosen by dtype:
//
// bf16 (the serve path): tensor cores, split-KV, the GQA group packed.
//   * A block works for one (batch, KV head) and a tile of packed rows: a row
//     is (query position, one of the H/K heads that share the KV head), so
//     each K/V tile staged in shared memory serves the whole group and every
//     K/V byte is read from device memory once per split.
//   * Q K^T and P V are mma.sync.m16n8k16 in bf16 with fp32 accumulators.
//     Q's A fragments stay in registers for the whole sweep; the online
//     softmax runs on the accumulator fragments (row max and sum over the
//     four lanes of a quad); P is re-packed in registers as the A operand
//     of P V, in bf16 (v's dtype), as a high and a low part (two products,
//     ~16 bits of weight): one rounding of P to bf16 moved the fp32 result
//     across a rounding midpoint of bf16 outputs often enough to break the
//     bf16 check (4e-3 allows no ulp at |out| >= 2); K feeds ldmatrix, V
//     ldmatrix.trans.
//   * K/V tiles of 64 keys come in by 16-byte cp.async into a ring of three
//     stages, so the next tiles' loads overlap the current tile's math; one
//     __syncthreads per tile.  Shared-memory rows are padded by 16 bytes, so
//     the eight rows of each ldmatrix fall in distinct banks.  Keys at or
//     past the block's last visible key are zero-filled (never read), tiles
//     past it are skipped, and the masks are applied on edge tiles only.
//   * Two layouts of a block's four warps, groups of 16 rows times groups of
//     keys of every tile.  Rows mode (more than 16 packed rows, prefill): 64
//     rows a block, 16 a warp, each warp over all 64 keys of a tile, writing
//     its rows from the fragments.  Keys mode (at most 16 packed rows,
//     decode: 4 rows for llama3.2-1b's group of 4): one 16-row tile, each
//     warp over 16 keys of every tile; the four partial softmaxes merge
//     through shared memory at the end.
//   * Split-KV (flash-decoding).  The grid is (row tiles, batch * KV heads,
//     splits); split s takes the key tiles s, s + S, s + 2S, ... so the
//     splits share the visible keys evenly whatever kv_len and q_offset are
//     on the device.  With S > 1 each split writes an fp32 partial (m, l and
//     the unnormalised accumulator) to scratch that the wrapper allocates;
//     a split with no visible key writes the neutral partial (m = -1e30,
//     l = 0) and no accumulator.  flash_combine_kernel then merges the
//     partials by log-sum-exp; it is launched as a programmatic dependent
//     (its launch overlaps the split kernel's end, and it waits on the grid's
//     writes with griddepcontrol.wait).  With S = 1 the block writes the
//     output and no combine runs.  The wrapper chooses S from host-known shapes and the
//     SM count only (ops.py::launch_plan), so nothing waits on the device.
//   Why mma.sync and not wgmma: at the serve path's shapes the grid is about
//   one wave, and the serial KV loop's latency sets the time, not the peak
//   rate.  What bounds the kernel on the card is in PERF.md.
//
// fp32 (tests, the fp32 compute option): the CUDA-core body, one block of 4
//   warps per (batch * head, 16-query tile), lane c scores key c of a 32-key
//   tile.  TF32 tensor cores would miss the 2e-5 fp32 tolerance, and no main
//   path runs attention in fp32.
//
// C interface (ctypes): every pointer and the stream are void*; q_offset and
// kv_len are int32 device arrays of B entries or null (0 and Skv); dtype 0 =
// float32, 1 = bfloat16; split_keys, splits and scratch are the wrapper's
// plan (bf16 only; scratch holds splits * B * Sq * H * (D + 2) floats when
// splits > 1).  Returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// fp32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kF32Warps = 4;
constexpr int kF32RowsPerWarp = 4;
constexpr int kF32BlockQ = kF32Warps * kF32RowsPerWarp;  // 16 query rows per block
constexpr int kF32BlockK = 32;                           // one key per lane

template <int D>
__global__ void __launch_bounds__(kF32Warps * 32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 const int* __restrict__ q_offset, const int* __restrict__ kv_len,
                 int sq, int skv, int heads, int kv_heads, int causal, float scale) {
  constexpr int kCols = D / 32;  // output columns per lane
  __shared__ float q_s[kF32BlockQ][D];
  __shared__ float k_s[kF32BlockK][D + 1];
  __shared__ float v_s[kF32BlockK][D];

  const int bh = blockIdx.x;
  const int b = bh / heads, h = bh % heads;
  const int kh = h / (heads / kv_heads);
  const int q0 = blockIdx.y * kF32BlockQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  const int qoff = q_offset ? q_offset[b] : 0;
  int kvl = kv_len ? kv_len[b] : skv;
  kvl = min(max(kvl, 0), skv);
  // keys that any row of this tile may see; tiles past it are skipped
  int n_keys = kvl;
  if (causal) n_keys = min(n_keys, max(qoff + min(q0 + kF32BlockQ, sq), 0));

  for (int idx = threadIdx.x; idx < kF32BlockQ * D; idx += kF32Warps * 32) {
    const int r = idx / D, d = idx % D, qi = q0 + r;
    q_s[r][d] = qi < sq ? q[((static_cast<int64_t>(b) * sq + qi) * heads + h) * D + d] * scale
                        : 0.f;
  }

  float m[kF32RowsPerWarp], l[kF32RowsPerWarp], acc[kF32RowsPerWarp][kCols];
#pragma unroll
  for (int i = 0; i < kF32RowsPerWarp; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }
  __syncthreads();

  for (int kb = 0; kb < n_keys; kb += kF32BlockK) {
    for (int idx = threadIdx.x; idx < kF32BlockK * D; idx += kF32Warps * 32) {
      const int c = idx / D, d = idx % D, kj = kb + c;
      float kv = 0.f, vv = 0.f;
      if (kj < n_keys) {
        const int64_t off = ((static_cast<int64_t>(b) * skv + kj) * kv_heads + kh) * D + d;
        kv = k[off];
        vv = v[off];
      }
      k_s[c][d] = kv;
      v_s[c][d] = vv;
    }
    __syncthreads();

    // scores: lane = key of the tile, 4 rows at once (one K read per d)
    float s[kF32RowsPerWarp];
#pragma unroll
    for (int i = 0; i < kF32RowsPerWarp; ++i) s[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane][d];
#pragma unroll
      for (int i = 0; i < kF32RowsPerWarp; ++i) s[i] += q_s[warp * kF32RowsPerWarp + i][d] * kd;
    }

    const int kj = kb + lane;
    float p[kF32RowsPerWarp];
#pragma unroll
    for (int i = 0; i < kF32RowsPerWarp; ++i) {
      const int qi = q0 + warp * kF32RowsPerWarp + i;
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
    for (int c = 0; c < kF32BlockK; ++c) {
      float vc[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vc[j] = v_s[c][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < kF32RowsPerWarp; ++i) {
        const float pc = __shfl_sync(0xffffffffu, p[i], c);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] += pc * vc[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kF32RowsPerWarp; ++i) {
    const int qi = q0 + warp * kF32RowsPerWarp + i;
    if (qi >= sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = o + ((static_cast<int64_t>(b) * sq + qi) * heads + h) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[lane + 32 * j] = acc[i][j] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const void* q_offset, const void* kv_len, int batch, int sq,
               int skv, int heads, int kv_heads, int causal, float scale,
               cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(batch * heads),
                  static_cast<unsigned>((sq + kF32BlockQ - 1) / kF32BlockQ));
  if (grid.x > 0 && grid.y > 0) {
    flash_f32_kernel<D><<<grid, kF32Warps * 32, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o),
        static_cast<const int*>(q_offset), static_cast<const int*>(kv_len),
        sq, skv, heads, kv_heads, causal, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, split-KV, GQA-packed rows
// ---------------------------------------------------------------------------

constexpr int kBlockN = 64;     // keys per K/V tile (ops.py BLOCK_N)
constexpr int kStages = 3;      // cp.async ring
constexpr int kPad = 8;         // bf16 padding per shared-memory row (16 bytes)
constexpr int kMaxSplits = 32;  // one lane of the combine per split (ops.py MAX_SPLITS)

struct MmaParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* part_acc;     // [splits][n_rows][D]
  float* part_ml;      // [splits][n_rows][2]: m, l
  const int* q_offset;
  const int* kv_len;
  int64_t n_rows;      // B * Sq * H: rows of o
  int sq, skv, heads, kv_heads, group, rows;  // rows = Sq * group, per (b, kv head)
  int causal, splits;
  float scale;
};

// The warps of a block: kRowWarps groups of 16 rows times kKeyWarps groups
// of keys of every tile.  Keys mode: 1 x 4 (16 rows; 16 keys a warp), rows
// mode: 4 x 1 (64 rows; all 64 keys a warp).  Rows mode as 4 x 2 (two warps
// on each SM sub-partition) and a software-pipelined KV loop (Q K^T of the
// next tile beside the softmax of this one) both measured slower on the
// H100 (PERF.md).
template <bool kSplitKeys>
struct Layout {
  static constexpr int kRowWarps = kSplitKeys ? 1 : 4;
  static constexpr int kKeyWarps = kSplitKeys ? 4 : 1;
  static constexpr int kThreads = 32 * kRowWarps * kKeyWarps;
  static constexpr int kRowsBlock = 16 * kRowWarps;
  static constexpr int kWarpKeys = kBlockN / kKeyWarps;
};

template <int D>
__host__ __device__ constexpr int stage_elems() { return kBlockN * (D + kPad); }

template <int D>
__host__ __device__ constexpr int mma_smem_bytes() { return 2 * kStages * stage_elems<D>() * 2; }

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

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout of m16n8k16 (lane = 4 g + t): A regs hold rows g / g + 8
// and columns 2t, 2t + 1 / 2t + 8, 2t + 9; B regs hold k = 2t, 2t + 1 /
// 2t + 8, 2t + 9 of column g; C holds rows g (c0, c1) and g + 8 (c2, c3) at
// columns 2t, 2t + 1.
template <int D, bool kSplitKeys>
__global__ void __launch_bounds__(Layout<kSplitKeys>::kThreads)
flash_mma_kernel(const MmaParams p) {
  using L = Layout<kSplitKeys>;
  constexpr int kThreads = L::kThreads;
  constexpr int kRowsBlock = L::kRowsBlock;
  constexpr int kKeyWarps = L::kKeyWarps;
  constexpr int kWarpKeys = L::kWarpKeys;          // keys of a tile per warp
  constexpr int kNT = kWarpKeys / 8;               // score n-tiles per warp
  constexpr int kKS = D / 16;                      // k-steps of Q K^T
  constexpr int kDT = D / 8;                       // accumulator n-tiles
  constexpr int kStride = D + kPad;                // shared row, bf16 elements
  constexpr int kChunksRow = D / 8;                // 16-byte chunks per K/V row
  constexpr int kChunks = kBlockN * kChunksRow;
  constexpr int kRS = D + 4;                       // merge row, floats
  static_assert(kChunks % kThreads == 0, "tile chunks per thread");
  static_assert(kKeyWarps * kRowsBlock * (kRS + 2) * 4 <= mma_smem_bytes<D>(),
                "the merge fits in the ring");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + kStages * stage_elems<D>();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int tile_r0 = blockIdx.x * kRowsBlock;
  const int b = blockIdx.y / p.kv_heads, kh = blockIdx.y % p.kv_heads;
  const int split = blockIdx.z;
  const int G = p.group;

  const int qoff = p.q_offset ? p.q_offset[b] : 0;
  int kvl = p.kv_len ? p.kv_len[b] : p.skv;
  kvl = min(max(kvl, 0), p.skv);
  const int rows_here = min(kRowsBlock, p.rows - tile_r0);
  // n_keys: keys any row of the block sees; full_keys: keys every row sees
  int n_keys = kvl, full_keys = kvl;
  if (p.causal) {
    const int q_first = tile_r0 / G, q_last = (tile_r0 + rows_here - 1) / G;
    n_keys = min(kvl, max(qoff + q_last + 1, 0));
    full_keys = min(kvl, max(qoff + q_first + 1, 0));
  }
  const int n_tiles = (n_keys + kBlockN - 1) / kBlockN;
  const int my_tiles = split < n_tiles ? (n_tiles - 1 - split) / p.splits + 1 : 0;

  // this lane's two rows (g and g + 8 of the warp's 16)
  const int wk = warp / L::kRowWarps;               // key group
  const int wr0 = (warp % L::kRowWarps) * 16;
  const int kw = wk * kWarpKeys;
  const bool warp_active = tile_r0 + wr0 < p.rows;
  bool valid[2];
  int lim[2];
  int64_t orow[2];
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int pr = tile_r0 + wr0 + g + 8 * h2;
    valid[h2] = pr < p.rows;
    const int qi = pr / G, gg = pr % G;
    orow[h2] = (static_cast<int64_t>(b) * p.sq + qi) * p.heads + kh * G + gg;
    lim[h2] = valid[h2] ? (p.causal ? min(kvl, max(qoff + qi + 1, 0)) : kvl) : 0;
  }

  // Q's A fragments, in registers for the whole sweep (zeros past the rows)
  uint32_t qa[kKS][4];
  {
    const __nv_bfloat16* q0 = p.q + (valid[0] ? orow[0] : 0) * D;
    const __nv_bfloat16* q1 = p.q + (valid[1] ? orow[1] : 0) * D;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int c = ks * 16 + 2 * tig;
      qa[ks][0] = valid[0] ? ld_u32(q0 + c) : 0u;
      qa[ks][1] = valid[1] ? ld_u32(q1 + c) : 0u;
      qa[ks][2] = valid[0] ? ld_u32(q0 + c + 8) : 0u;
      qa[ks][3] = valid[1] ? ld_u32(q1 + c + 8) : 0u;
    }
  }

  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int64_t kv_row = static_cast<int64_t>(p.kv_heads) * D;  // elements between keys
  const __nv_bfloat16* kbase = p.k + (static_cast<int64_t>(b) * p.skv * p.kv_heads + kh) * D;
  const __nv_bfloat16* vbase = p.v + (static_cast<int64_t>(b) * p.skv * p.kv_heads + kh) * D;
  const uint32_t k_s0 = smem_u32(k_s), v_s0 = smem_u32(v_s);

  auto load_tile = [&](int tile, int stage) {
    const int key0 = tile * kBlockN;
#pragma unroll
    for (int i = 0; i < kChunks / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kChunksRow, ch = c % kChunksRow;
      const int key = key0 + r;
      const bool ok = key < n_keys;
      const int64_t off = (ok ? key : 0) * kv_row + ch * 8;
      const uint32_t so = static_cast<uint32_t>((stage * stage_elems<D>() + r * kStride + ch * 8) * 2);
      cp_async16(k_s0 + so, kbase + off, ok ? 16 : 0);
      cp_async16(v_s0 + so, vbase + off, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < my_tiles) load_tile(split + s * p.splits, s);
    cp_async_commit();
  }

  for (int it = 0; it < my_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile `it` has landed (this thread's part)
    __syncthreads();               // ... every thread's part; stage it-1 is free
    {
      const int nxt = it + kStages - 1;
      if (nxt < my_tiles) load_tile(split + nxt * p.splits, nxt % kStages);
      cp_async_commit();
    }
    if (!warp_active) continue;
    const int tile = split + it * p.splits;
    const int stage = it % kStages;
    const uint32_t ks_base = k_s0 + stage * stage_elems<D>() * 2;
    const uint32_t vs_base = v_s0 + stage * stage_elems<D>() * 2;

    // S = Q K^T over this warp's keys of the tile
    float s[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        const int key_r = kw + np * 16 + (lane & 7) + (lane >> 4) * 8;
        const int d_c = ks * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(ks_base + (key_r * kStride + d_c) * 2, b0, b1, b2, b3);
        mma_bf16(s[2 * np], qa[ks], b0, b1);
        mma_bf16(s[2 * np + 1], qa[ks], b2, b3);
      }
    }

    // scale the fp32 scores; mask on edge tiles only
    const bool edge = tile * kBlockN + kBlockN > full_keys;
    const int key_base = tile * kBlockN + kw + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[nt][c] * p.scale;
        if (edge && key_base + nt * 8 + (c & 1) >= lim[c >> 1]) x = kNegInf;
        s[nt][c] = x;
      }
    }

    // online softmax on the fragments: a row lives on the four lanes of a quad
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
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const float e0 = exp2f(s[nt][2 * h2] * kLog2e - base);
        const float e1 = exp2f(s[nt][2 * h2 + 1] * kLog2e - base);
        s[nt][2 * h2] = e0;
        s[nt][2 * h2 + 1] = e1;
        sum += e0 + e1;
      }
      l[h2] = l[h2] * corr + sum;  // this lane's part; the quad sums at the end
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        acc[dt][2 * h2] *= corr;
        acc[dt][2 * h2 + 1] *= corr;
      }
    }

    // acc += P V, P re-packed in registers as the A operand: bf16 high and
    // low parts, two products, so the weights keep ~16 bits
#pragma unroll
    for (int kk = 0; kk < kNT / 2; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        const int key_r = kw + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int d_c = dp * 16 + (lane >> 4) * 8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4_trans(vs_base + (key_r * kStride + d_c) * 2, b0, b1, b2, b3);
        mma_bf16(acc[2 * dp], ph, b0, b1);
        mma_bf16(acc[2 * dp + 1], ph, b2, b3);
        mma_bf16(acc[2 * dp], pl, b0, b1);
        mma_bf16(acc[2 * dp + 1], pl, b2, b3);
      }
    }
  }

  // the combine kernel may start launching now; it waits for this grid's
  // writes (griddepcontrol.wait) before it reads a partial
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 1);
    l[h2] += __shfl_xor_sync(0xffffffffu, l[h2], 2);
  }

  if constexpr (kKeyWarps == 1) {
    // rows mode: each warp owns its rows; write from the fragments
    if (!warp_active) return;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      if (!valid[h2]) continue;
      if (p.splits == 1) {
        const float inv = 1.f / fmaxf(l[h2], 1e-30f);
        __nv_bfloat16* o_p = p.o + orow[h2] * D + 2 * tig;
#pragma unroll
        for (int dt = 0; dt < kDT; ++dt)
          *reinterpret_cast<__nv_bfloat162*>(o_p + dt * 8) =
              __floats2bfloat162_rn(acc[dt][2 * h2] * inv, acc[dt][2 * h2 + 1] * inv);
      } else {
        const int64_t prow = static_cast<int64_t>(split) * p.n_rows + orow[h2];
        if (l[h2] > 0.f) {
          float* a_p = p.part_acc + prow * D + 2 * tig;
#pragma unroll
          for (int dt = 0; dt < kDT; ++dt)
            *reinterpret_cast<float2*>(a_p + dt * 8) = make_float2(acc[dt][2 * h2], acc[dt][2 * h2 + 1]);
        }
        if (tig == 0)
          *reinterpret_cast<float2*>(p.part_ml + prow * 2) = make_float2(m[h2], l[h2]);
      }
    }
  } else {
    // keys mode: merge the key groups' softmaxes over the same rows (the
    // ring is free)
    cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem_raw);    // [key group][row][kRS]
    float* red_ml = red + kKeyWarps * kRowsBlock * kRS;  // [key group][row][2]
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = wk * kRowsBlock + wr0 + g + 8 * h2;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt)
        *reinterpret_cast<float2*>(red + r * kRS + dt * 8 + 2 * tig) =
            make_float2(acc[dt][2 * h2], acc[dt][2 * h2 + 1]);
      if (tig == 0) *reinterpret_cast<float2*>(red_ml + r * 2) = make_float2(m[h2], l[h2]);
    }
    __syncthreads();
    // two columns a thread: bf16x2 output, float2 partials
    for (int e = threadIdx.x; e < kRowsBlock * D / 2; e += kThreads) {
      const int r = e / (D / 2), col = 2 * (e % (D / 2));
      const int pr = tile_r0 + r;
      if (pr >= p.rows) continue;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kKeyWarps; ++w) {
        const float2 ml = *reinterpret_cast<const float2*>(red_ml + (w * kRowsBlock + r) * 2);
        if (ml.y > 0.f) mx = fmaxf(mx, ml.x);
      }
      float lsum = 0.f, a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int w = 0; w < kKeyWarps; ++w) {
        const float2 ml = *reinterpret_cast<const float2*>(red_ml + (w * kRowsBlock + r) * 2);
        if (ml.y > 0.f) {
          const float f = exp2f((ml.x - mx) * kLog2e);
          const float2 av = *reinterpret_cast<const float2*>(red + (w * kRowsBlock + r) * kRS + col);
          lsum += f * ml.y;
          a0 += f * av.x;
          a1 += f * av.y;
        }
      }
      const int qi = pr / G, gg = pr % G;
      const int64_t o_r = (static_cast<int64_t>(b) * p.sq + qi) * p.heads + kh * G + gg;
      if (p.splits == 1) {
        const float inv = 1.f / fmaxf(lsum, 1e-30f);
        *reinterpret_cast<__nv_bfloat162*>(p.o + o_r * D + col) = __floats2bfloat162_rn(a0 * inv, a1 * inv);
      } else {
        const int64_t prow = static_cast<int64_t>(split) * p.n_rows + o_r;
        if (lsum > 0.f) *reinterpret_cast<float2*>(p.part_acc + prow * D + col) = make_float2(a0, a1);
        if (col == 0)
          *reinterpret_cast<float2*>(p.part_ml + prow * 2) = make_float2(lsum > 0.f ? mx : kNegInf, lsum);
      }
    }
  }
}

// One warp per output row: merge the splits' partials by log-sum-exp.  Lane
// s holds split s's (m, l) (splits <= 32), so the weights come from one
// round of loads and shuffles; the accumulators then load unconditionally
// (a neutral split, which wrote none, reads a split that did, at weight 0),
// so the loads of several splits are in flight at once.
template <int D>
__global__ void __launch_bounds__(128)
flash_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     __nv_bfloat16* __restrict__ o, int64_t n_rows, int splits) {
  constexpr int kPer = D / 32;  // columns per lane: 1, 2 or 4
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the partials are written
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 4 + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int lane = threadIdx.x & 31;
  float m_s = kNegInf, l_s = 0.f;
  if (lane < splits) {
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + (lane * n_rows + row) * 2);
    m_s = ml.x;
    l_s = ml.y;
  }
  const bool has = l_s > 0.f;
  const float mx = warp_max(has ? m_s : kNegInf);
  const float f = has ? exp2f((m_s - mx) * kLog2e) : 0.f;
  const float lsum = warp_sum(f * l_s);
  const unsigned with = __ballot_sync(0xffffffffu, has);
  float a[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) a[j] = 0.f;
  if (with != 0u) {
    const int any = __ffs(with) - 1;  // a split that wrote its accumulator
    const float* base = part_acc + row * D + lane * kPer;
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float fs = __shfl_sync(0xffffffffu, f, s);
      const float* src = base + static_cast<int64_t>(fs > 0.f ? s : any) * n_rows * D;
      if constexpr (kPer == 4) {
        const float4 t = *reinterpret_cast<const float4*>(src);
        a[0] += fs * t.x; a[1] += fs * t.y; a[2] += fs * t.z; a[3] += fs * t.w;
      } else if constexpr (kPer == 2) {
        const float2 t = *reinterpret_cast<const float2*>(src);
        a[0] += fs * t.x; a[1] += fs * t.y;
      } else {
        a[0] += fs * src[0];
      }
    }
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  __nv_bfloat16* dst = o + row * D + lane * kPer;
  if constexpr (kPer == 1) {
    dst[0] = __float2bfloat16(a[0] * inv);
  } else {
#pragma unroll
    for (int j = 0; j < kPer; j += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + j) = __floats2bfloat162_rn(a[j] * inv, a[j + 1] * inv);
  }
}

template <int D, bool kSplitKeys>
int launch_mma(const MmaParams& p, int batch, int splits, cudaStream_t stream) {
  constexpr int smem = mma_smem_bytes<D>();
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_mma_kernel<D, kSplitKeys>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  using L = Layout<kSplitKeys>;
  const dim3 grid(static_cast<unsigned>((p.rows + L::kRowsBlock - 1) / L::kRowsBlock),
                  static_cast<unsigned>(batch * p.kv_heads), static_cast<unsigned>(splits));
  flash_mma_kernel<D, kSplitKeys><<<grid, L::kThreads, smem, stream>>>(p);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || splits == 1) return err;
  // programmatic dependent launch: the combine's launch overlaps the end of
  // the split kernel instead of following it
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((p.n_rows + 3) / 4));
  cfg.blockDim = dim3(128);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, flash_combine_kernel<D>,
                                            static_cast<const float*>(p.part_acc),
                                            static_cast<const float*>(p.part_ml), p.o,
                                            p.n_rows, splits));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch_mma(const MmaParams& p, int batch, int split_keys, int splits, cudaStream_t s) {
  return split_keys ? launch_mma<D, true>(p, batch, splits, s)
                    : launch_mma<D, false>(p, batch, splits, s);
}

}  // namespace

extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, const void* q_offset,
                                   const void* kv_len, void* scratch, int batch,
                                   int sq, int skv, int heads, int kv_heads,
                                   int d, int causal, float scale, int dtype,
                                   int split_keys, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || sq <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads)
    return batch == 0 || sq == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (d) {
      case 32: return launch_f32<32>(q, k, v, o, q_offset, kv_len, batch, sq, skv, heads, kv_heads, causal, scale, s);
      case 64: return launch_f32<64>(q, k, v, o, q_offset, kv_len, batch, sq, skv, heads, kv_heads, causal, scale, s);
      case 128: return launch_f32<128>(q, k, v, o, q_offset, kv_len, batch, sq, skv, heads, kv_heads, causal, scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype != 1 || splits < 1 || splits > kMaxSplits || (splits > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  MmaParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.n_rows = static_cast<int64_t>(batch) * sq * heads;
  p.part_acc = static_cast<float*>(scratch);
  p.part_ml = splits > 1 ? p.part_acc + static_cast<int64_t>(splits) * p.n_rows * d : nullptr;
  p.q_offset = static_cast<const int*>(q_offset);
  p.kv_len = static_cast<const int*>(kv_len);
  p.sq = sq;
  p.skv = skv;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.group = heads / kv_heads;
  p.rows = sq * p.group;
  p.causal = causal;
  p.splits = splits;
  p.scale = scale;
  switch (d) {
    case 32: return dispatch_mma<32>(p, batch, split_keys, splits, s);
    case 64: return dispatch_mma<64>(p, batch, split_keys, splits, s);
    case 128: return dispatch_mma<128>(p, batch, split_keys, splits, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
