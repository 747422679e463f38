// Paged multi-head latent attention (MLA) in the absorbed form, for Hopper
// (sm_90a): decode and chunked prefill of the serve path in one kernel.
//
// Replaces no TPU kernel: the JAX package has no latent attention.  It was
// added to serve MLA models (DeepSeek-V3, Kimi-K2) through the paged engine:
// a token's cache entry is one latent row of D = R + 64 values (the normed
// latent c, R = 512 wide, and the rotated k_pe), shared by every head, where
// per-head K/V would hold 64 heads x (192 + 128) values.
//
// What it computes.  Token t of a call (its lane lane[t], its position
// pos[t]) has H query rows q[t, h] of D values (q_nope W_uk beside q_pe).
// Its keys are its lane's cache rows 0 .. pos[t], read through the block
// table: row j lives in page tables[lane, j / block_size] at j % block_size.
// For each head,
//   s_j = scale * q . c_j  (all D values),   p = softmax(s),
//   o   = sum_j p_j c_j[0:R]                                    (R values)
// in fp32 (scores, max, sums, the accumulator), o written in bf16.  A decode
// call is one token a lane (pos = the lane's length); a prefill chunk is a
// lane's tokens at consecutive positions (causal within the chunk: the
// chunk's own rows are in the pool before the call).
//
// Bound on this card.  Decode: each lane's latent to its length is read
// once, 1,152 B a key, against 2 x 64 x (576 + 512) operations a key: about
// 121 operations a byte, under the card's ~295: bytes.  A chunk of 2,048
// tokens reads each key once from device memory for all its tokens: the
// operations bound it.
//
// Design.  A block owns 64 query rows (the 64 heads of one token, or one
// group of 64 of H) and a split of the token's key tiles of 32 keys: tile
// i of split s is s + i x splits, so the splits share the visible keys
// evenly whatever the lengths on the device are.  Eight warps: warp w takes
// rows 16 (w % 4) .. +16; for the scores, keys 16 (w / 4) .. +16 of the
// tile over all D; for the output, columns 256 (w / 4) .. +256 over all 32
// keys.  Q (64 x D) stays in shared memory; key tiles come in by 16-byte
// cp.async into a ring of three stages (zero-filled past the last visible
// key); the two warps of a row group exchange row maxima and sums through
// shared memory, P goes to shared memory in bf16 (one rounding, as the
// other flash-style kernels of the field do), and the same key tile serves
// Q K^T (ldmatrix) and P V (ldmatrix.trans of its first R columns: the
// latent is both the key and the value).  mma.sync m16n8k16, bf16 in, fp32
// out.  Every row of a block has the same visible keys (one token), so
// the mask falls on the last tile alone.  With splits > 1 each block writes
// its fp32 partial (the unnormalised accumulator, m and l; a split with no
// visible tile writes l = 0 and no accumulator) and mla_combine_kernel
// merges them by log-sum-exp.
//
// C interface (ctypes): pointers and the stream void*; q (T, H, D) and out
// (T, H, R) bf16, pages (blocks, block_size, D) bf16, tables (lanes,
// max_blocks), lane and pos (T) int32, o_part (splits, T, H, R) and ml
// (splits, T, H, 2) fp32 scratch where splits > 1.  D = 576, R = 512, H a
// multiple of 64, block_size a multiple of 32, else cudaErrorInvalidValue.
// Returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 576;            // latent row: R + rope
constexpr int kR = 512;            // the latent c (the values)
constexpr int kRows = 64;          // query rows a block
constexpr int kKeys = 32;          // keys a tile
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kPad = 8;            // row padding: ldmatrix's eight rows in distinct banks
constexpr int kStride = kD + kPad;
constexpr int kPStride = kKeys + kPad;
constexpr int kMaxSplits = 64;
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kQBytes = kRows * kStride * 2;
constexpr int kTileBytes = kKeys * kStride * 2;
constexpr int kPBytes = kRows * kPStride * 2;
constexpr int kSmem = kQBytes + kStages * kTileBytes + kPBytes + 4 * kRows * 4;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* pages;
  const int* tables;
  const int* lane;
  const int* pos;
  __nv_bfloat16* out;
  float* o_part;
  float* ml;
  int tokens, heads, block_size, max_blocks, splits;
  float scale;
};

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
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

// Fragment layout of m16n8k16 (lane = 4 g + t): C holds rows g (c0, c1) and
// g + 8 (c2, c3) at columns 2t, 2t + 1.
__global__ void __launch_bounds__(kThreads, 1) mla_attn_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + kQBytes);
  __nv_bfloat16* p_s =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + kQBytes + kStages * kTileBytes);
  float* red_max = reinterpret_cast<float*>(smem_raw + kQBytes + kStages * kTileBytes + kPBytes);
  float* red_sum = red_max + 2 * kRows;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int groups = p.heads / kRows;
  const int t = blockIdx.x / groups, hg = blockIdx.x % groups;
  const int split = blockIdx.y;
  const int rg = warp & 3, kh = warp >> 2;          // row group; key / column half
  const int r0 = rg * 16;

  const int view = p.max_blocks * p.block_size;
  const int n_keys = min(max(p.pos[t], 0) + 1, view);
  const int n_tiles = (n_keys + kKeys - 1) / kKeys;
  const int my_tiles = split < n_tiles ? (n_tiles - 1 - split) / p.splits + 1 : 0;
  const int* table = p.tables + static_cast<int64_t>(p.lane[t]) * p.max_blocks;
  const int64_t row0 = static_cast<int64_t>(t) * p.heads + hg * kRows;  // first query row

  const uint32_t q_s0 = smem_u32(q_s), k_s0 = smem_u32(k_s), p_s0 = smem_u32(p_s);
  constexpr int kChunksRow = kD / 8;                 // 16-byte chunks a row: 72

  auto load_tile = [&](int tile, int stage) {
    const int key0 = tile * kKeys;
    const int64_t page = table[key0 / p.block_size];
    const __nv_bfloat16* src0 =
        p.pages + (page * p.block_size + key0 % p.block_size) * kD;
#pragma unroll
    for (int i = 0; i < kKeys * kChunksRow / kThreads; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int r = c / kChunksRow, ch = c % kChunksRow;
      const bool ok = key0 + r < n_keys;
      const uint32_t so = static_cast<uint32_t>(stage * kTileBytes + (r * kStride + ch * 8) * 2);
      cp_async16(k_s0 + so, src0 + (ok ? r : 0) * kD + ch * 8, ok ? 16 : 0);
    }
  };

  if (my_tiles > 0) {
    const __nv_bfloat16* qsrc = p.q + row0 * kD;
    for (int c = threadIdx.x; c < kRows * kChunksRow; c += kThreads) {
      const int r = c / kChunksRow, ch = c % kChunksRow;
      cp_async16(q_s0 + (r * kStride + ch * 8) * 2, qsrc + r * kD + ch * 8, 16);
    }
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < my_tiles) load_tile(split + s * p.splits, s);
    cp_async_commit();
  }

  float acc[32][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < my_tiles; ++it) {
    cp_async_wait<kStages - 2>();  // tile `it` (and Q) landed: this thread's part
    __syncthreads();               // ... every thread's; the previous tile is done with
    {
      const int nxt = it + kStages - 1;
      if (nxt < my_tiles) load_tile(split + nxt * p.splits, nxt % kStages);
      cp_async_commit();
    }
    const int tile = split + it * p.splits;
    const uint32_t ks = k_s0 + (it % kStages) * kTileBytes;

    // S = Q K^T: 16 rows x this warp's 16 keys, over all D
    float s[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < kD / 16; ++kk) {
      uint32_t a[4], b[4];
      ldmatrix_x4(q_s0 + ((r0 + (lane & 15)) * kStride + kk * 16 + (lane >> 4) * 8) * 2, a);
      ldmatrix_x4(ks + ((kh * 16 + (lane & 7) + (lane >> 4) * 8) * kStride + kk * 16 +
                        ((lane >> 3) & 1) * 8) * 2, b);
      mma_bf16(s[0], a, b[0], b[1]);
      mma_bf16(s[1], a, b[2], b[3]);
    }
    const int key_base = tile * kKeys + kh * 16 + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = key_base + nt * 8 + (c & 1) < n_keys;
        s[nt][c] = ok ? s[nt][c] * p.scale : kNegInf;
      }

    // the row maxima of both key halves
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float mx = fmaxf(fmaxf(s[0][2 * h2], s[0][2 * h2 + 1]), fmaxf(s[1][2 * h2], s[1][2 * h2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (tig == 0) red_max[kh * kRows + r0 + g + 8 * h2] = mx;
    }
    __syncthreads();
    float corr[2];
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = r0 + g + 8 * h2;
      // every tile holds a visible key, so the maximum is finite
      const float mx = fmaxf(m[h2], fmaxf(red_max[row], red_max[kRows + row]));
      const float base = mx * kLog2e;
      corr[h2] = exp2f(m[h2] * kLog2e - base);
      m[h2] = mx;
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float e0 = exp2f(s[nt][2 * h2] * kLog2e - base);
        const float e1 = exp2f(s[nt][2 * h2 + 1] * kLog2e - base);
        sum += e0 + e1;
        *reinterpret_cast<__nv_bfloat162*>(p_s + row * kPStride + kh * 16 + nt * 8 + 2 * tig) =
            __floats2bfloat162_rn(e0, e1);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (tig == 0) red_sum[kh * kRows + row] = sum;
    }
#pragma unroll
    for (int dt = 0; dt < 32; ++dt) {
      acc[dt][0] *= corr[0];
      acc[dt][1] *= corr[0];
      acc[dt][2] *= corr[1];
      acc[dt][3] *= corr[1];
    }
    __syncthreads();
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = r0 + g + 8 * h2;
      l[h2] = l[h2] * corr[h2] + red_sum[row] + red_sum[kRows + row];
    }

    // O += P V: 16 rows x this warp's 256 columns, over the tile's 32 keys
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(p_s0 + ((r0 + (lane & 15)) * kPStride + kk * 16 + (lane >> 4) * 8) * 2, a);
#pragma unroll
      for (int dp = 0; dp < 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(ks + ((kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kStride +
                                kh * 256 + dp * 16 + (lane >> 4) * 8) * 2, b);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int64_t row = row0 + r0 + g + 8 * h2;
    const int col = kh * 256 + 2 * tig;
    if (p.splits == 1) {
      const float inv = 1.f / fmaxf(l[h2], 1e-30f);
      __nv_bfloat16* dst = p.out + row * kR + col;
#pragma unroll
      for (int dt = 0; dt < 32; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(dst + dt * 8) =
            __floats2bfloat162_rn(acc[dt][2 * h2] * inv, acc[dt][2 * h2 + 1] * inv);
    } else {
      const int64_t prow = static_cast<int64_t>(split) * p.tokens * p.heads + row;
      if (l[h2] > 0.f) {
        float* dst = p.o_part + prow * kR + col;
#pragma unroll
        for (int dt = 0; dt < 32; ++dt)
          *reinterpret_cast<float2*>(dst + dt * 8) = make_float2(acc[dt][2 * h2], acc[dt][2 * h2 + 1]);
      }
      if (kh == 0 && tig == 0)
        *reinterpret_cast<float2*>(p.ml + prow * 2) = make_float2(m[h2], l[h2]);
    }
  }
}

// One block of 128 threads a query row, four columns a thread: the splits'
// partials merged by log-sum-exp (a split with l = 0 wrote no accumulator
// and adds nothing).
__global__ void __launch_bounds__(128)
mla_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ ml,
                   __nv_bfloat16* __restrict__ out, int64_t rows, int splits) {
  const int64_t row = blockIdx.x;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) {
    const float2 v = *reinterpret_cast<const float2*>(ml + (s * rows + row) * 2);
    if (v.y > 0.f) mx = fmaxf(mx, v.x);
  }
  float lsum = 0.f;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  const int col = threadIdx.x * 4;
  for (int s = 0; s < splits; ++s) {
    const float2 v = *reinterpret_cast<const float2*>(ml + (s * rows + row) * 2);
    if (v.y > 0.f) {
      const float f = exp2f((v.x - mx) * kLog2e);
      const float4 x = *reinterpret_cast<const float4*>(o_part + (s * rows + row) * kR + col);
      lsum += f * v.y;
      a[0] += f * x.x;
      a[1] += f * x.y;
      a[2] += f * x.z;
      a[3] += f * x.w;
    }
  }
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  __nv_bfloat16* dst = out + row * kR + col;
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a[0] * inv, a[1] * inv);
  *reinterpret_cast<__nv_bfloat162*>(dst + 2) = __floats2bfloat162_rn(a[2] * inv, a[3] * inv);
}

}  // namespace

extern "C" int mla_attention_fwd(const void* q, const void* pages, const void* tables,
                                 const void* lane, const void* pos, void* out, void* o_part,
                                 void* ml, int tokens, int heads, int block_size,
                                 int max_blocks, int splits, float scale, void* stream) {
  if (tokens < 0 || heads <= 0 || heads % kRows || block_size <= 0 || block_size % kKeys ||
      max_blocks <= 0 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (o_part == nullptr || ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tokens == 0) return 0;
  static int allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(mla_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = 1;
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.pages = static_cast<const __nv_bfloat16*>(pages);
  p.tables = static_cast<const int*>(tables);
  p.lane = static_cast<const int*>(lane);
  p.pos = static_cast<const int*>(pos);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.o_part = static_cast<float*>(o_part);
  p.ml = static_cast<float*>(ml);
  p.tokens = tokens;
  p.heads = heads;
  p.block_size = block_size;
  p.max_blocks = max_blocks;
  p.splits = splits;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(tokens) * (heads / kRows)),
                  static_cast<unsigned>(splits));
  mla_attn_kernel<<<grid, kThreads, kSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(tokens) * heads;
  mla_combine_kernel<<<static_cast<unsigned>(rows), 128, 0, s>>>(
      p.o_part, p.ml, p.out, rows, splits);
  return static_cast<int>(cudaGetLastError());
}
