// Mamba-2 decode step, the recurrent core, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's models/mamba.py::mamba_step is
// plain jnp.  It was added because the decode step's state update is bound
// by bytes, and plain PyTorch made about nine passes over the fp32 state (the
// decay, the outer product, their sum, the readout, the copy back into the
// pool) with three temporaries the size of the state.
//
// What it computes, for each lane (a sequence) l and head h, one token:
//   xc = silu(conv(tail_x, xh) + bias_x)   rounded to the inputs' dtype   (p,)
//   Bc = silu(conv(tail_B, B) + bias_B)    the head's group, rounded      (n,)
//   Cc = silu(conv(tail_C, C) + bias_C)    the head's group, rounded      (n,)
//   dt' = softplus(dt + dt_bias[h]),  decay = exp(dt' * -exp(A_log[h]))
//   state <- state * decay + (Bc dt') (x) xc                   (n, p), fp32
//   y = Cc . state + D[h] xc               rounded to the inputs' dtype   (p,)
// conv: the causal depthwise conv of width w over the w-1 tail inputs and the
// new one; the new tails are the last w-1 of those w.  All arithmetic is
// fp32, in the plain version's order of roundings (ref.py: each product and
// sum of the state update rounded once, no contraction), save the conv's w
// terms and the readout's n terms, whose sums run in another order.
//
// A lane whose `active` byte is 0 steps nothing: it reads and writes no state
// and no tails where the outputs are its inputs (in place), copies them where
// they are not, and writes y = 0.
//
// Bound on this card.  A lane-head's state is n x p fp32 (128 x 64 = 32 KB at
// granite's and mamba2's widths), read once and written once; every other
// operand is under 2 % of that.  At the granite serve cell's decode call (128
// lanes x 128 heads) that is 1.07 GB, 0.32 ms at 3.35 TB/s, with 5 operations
// a state element (0.07 ms at the CUDA cores' fp32 rate): bytes.  Design:
// one block of 256 threads a (head, lane), 16,384 blocks at that shape.  The
// head's state tile comes into shared memory by 16-byte cp.async, issued
// first and in flight while the block computes the conv steps; each thread
// then updates up to 8 rows of 4 columns, stores them (streaming: the state
// is not read again in the call) and sums its part of C . state, and the
// partial sums over the rows meet in shared memory.  Six blocks an SM (32 KB
// of tile and 40 registers a thread each) keep ~190 KB of state in flight on
// every SM.  Measured on the H100 (PERF.md): holding the tile in registers
// instead (62 registers, four blocks an SM) took 0.41 ms at that shape, this
// layout 0.386 ms, a plain device copy of the state 0.357 ms; persistent
// blocks with a ring of two to four tiles took 0.44-0.74 ms.  x's conv
// channels belong to the head's block, so its tails may be updated in place;
// B's and C's belong to a group of heads whose blocks all read them, so the
// group's first head writes them to separate outputs (the wrapper copies them
// back).
//
// C interface (ctypes): pointers and the stream are void*; every tensor is
// contiguous, lanes outermost: xh, y (L, H, p); B, C (L, G, n); dt (L, H)
// fp32; tails x (L, w-1, H, p), B and C (L, w-1, G, n); state and state_out
// (L, H, n, p) fp32; conv weights x (w, H, p), B and C (w, G, n); biases x
// (H, p), B and C (G, n), or all three null; A_log, dt_bias, D (H,) fp32;
// active (L,) bytes, or null for all lanes.  Outputs may be their inputs.
// dtype codes 0 = float32, 1 = bfloat16: `dtype` for xh, B, C, the tails and
// y; `wdtype` for the conv weights and biases.  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for shapes it does not take
// (n > 128, p > 64 or not a multiple of 4, w > 4, G not dividing H, B's or
// C's tails in place where a group holds several heads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// resident blocks an SM: 6 x 32 KB of state tiles in shared memory, and
// at most 40 registers a thread
constexpr int kMinBlocks = 6;
constexpr int kMaxN = 128;      // d_state
constexpr int kMaxP = 64;       // head_dim
constexpr int kMaxW = 4;        // conv width
constexpr int kMaxDevices = 64;
// state rows a thread updates: kMaxN over the rows a pass covers at kMaxP
constexpr int kRows = kMaxN / (kThreads / (kMaxP / 4));

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// silu as PyTorch's CUDA kernel computes it: x / (1 + exp(-x))
__device__ __forceinline__ float silu(float v) {
  return __fdiv_rn(v, __fadd_rn(1.0f, expf(-v)));
}

// softplus with beta 1 and PyTorch's threshold 20
__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

struct Args {
  const void *xh, *B, *C;
  const float* dt;
  const void *tx, *tb, *tc;
  const float* state;
  const void *wx, *wb, *wc, *bx, *bb, *bc;
  const float *A_log, *dt_bias, *D;
  const uint8_t* active;
  float* state_out;
  void *tx_out, *tb_out, *tc_out, *y;
  int heads, groups, n, p, w;
};

// One conv channel: `tail` and `out_tail` point at its first tail input,
// `stride` apart; `wt` at its first weight, `wstride` apart.  Writes the new
// tail where `write` is set and returns silu(sum + bias) rounded to T.  The
// loops run to kMaxW with the taps past w masked, so the window stays in
// registers.
template <typename T, typename W>
__device__ __forceinline__ float conv_channel(const T* tail, T* out_tail, int64_t stride,
                                              T fresh, const W* wt, int64_t wstride,
                                              const W* bias, int w, bool write) {
  float win[kMaxW];
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxW; ++i) {
    if (i < w) {
      win[i] = i < w - 1 ? to_f32(tail[i * stride]) : to_f32(fresh);
      const float wv = to_f32(wt[i * wstride]);
      acc = i == 0 ? __fmul_rn(win[i], wv) : __fmaf_rn(win[i], wv, acc);
    }
  }
  if (bias) acc = __fadd_rn(acc, to_f32(*bias));
  if (write) {
#pragma unroll
    for (int i = 0; i < kMaxW - 1; ++i)
      if (i < w - 1) out_tail[i * stride] = i + 1 < w - 1 ? from_f32<T>(win[i + 1]) : fresh;
  }
  return to_f32(from_f32<T>(silu(acc)));
}

// An inactive lane: copy what is not in place, y = 0.
template <typename T>
__device__ void idle_lane(const Args& a, int lane, int h, bool lead) {
  const int tid = threadIdx.x, H = a.heads, G = a.groups, n = a.n, p = a.p, w1 = a.w - 1;
  T* y = static_cast<T*>(a.y) + (static_cast<int64_t>(lane) * H + h) * p;
  for (int i = tid; i < p; i += kThreads) y[i] = from_f32<T>(0.0f);
  const int64_t tile = static_cast<int64_t>(n) * p;
  if (a.state_out != a.state) {
    const float4* src = reinterpret_cast<const float4*>(a.state + (static_cast<int64_t>(lane) * H + h) * tile);
    float4* dst = reinterpret_cast<float4*>(a.state_out + (static_cast<int64_t>(lane) * H + h) * tile);
    for (int64_t i = tid; i < tile / 4; i += kThreads) __stcs(dst + i, __ldcs(src + i));
  }
  if (a.tx_out != a.tx) {
    const T* src = static_cast<const T*>(a.tx) + static_cast<int64_t>(lane) * w1 * H * p + h * p;
    T* dst = static_cast<T*>(a.tx_out) + static_cast<int64_t>(lane) * w1 * H * p + h * p;
    for (int i = tid; i < w1 * p; i += kThreads)
      dst[(i / p) * static_cast<int64_t>(H) * p + i % p] = src[(i / p) * static_cast<int64_t>(H) * p + i % p];
  }
  if (lead) {
    const int g = h / (H / G);
    const int64_t off = static_cast<int64_t>(lane) * w1 * G * n + g * n;
    for (int which = 0; which < 2; ++which) {
      const T* src = static_cast<const T*>(which ? a.tc : a.tb) + off;
      T* dst = static_cast<T*>(which ? a.tc_out : a.tb_out) + off;
      if (src == dst) continue;
      for (int i = tid; i < w1 * n; i += kThreads)
        dst[(i / n) * static_cast<int64_t>(G) * n + i % n] = src[(i / n) * static_cast<int64_t>(G) * n + i % n];
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads, kMinBlocks) mamba_step_kernel(Args a) {
  __shared__ __align__(16) float xs[kMaxP];
  __shared__ float bs[kMaxN], cs[kMaxN];
  __shared__ float4 red[kThreads];
  const int h = blockIdx.x, lane = blockIdx.y, tid = threadIdx.x;
  const int H = a.heads, G = a.groups, n = a.n, p = a.p, w = a.w, w1 = w - 1;
  const int hpg = H / G, g = h / hpg;
  const bool lead = h % hpg == 0;
  if (a.active && !a.active[lane]) {
    idle_lane<T>(a, lane, h, lead);
    return;
  }

  // 1. the head's state tile into shared memory, by 16-byte cp.async, in
  //    flight through the conv prologue; thread (r0, col) then updates rows
  //    r0, r0 + rpp, ... of columns [4 col, 4 col + 4)
  const int c4 = p / 4, rpp = kThreads / c4, r0 = tid / c4, col = tid % c4;
  const bool holds = tid < rpp * c4;
  const int64_t tile = (static_cast<int64_t>(lane) * H + h) * n * p;
  extern __shared__ float4 tile_s[];  // n x p fp32, row-major
  {
    const float4* st = reinterpret_cast<const float4*>(a.state + tile);
    for (int i = tid; i < n * c4; i += kThreads) cp_async16(tile_s + i, st + i);
    cp_async_commit();
  }

  // 2. the conv steps of x (the head's p channels) and of B and C (the
  //    group's n channels each), the new tails, and dt's activation
  const int64_t lh = static_cast<int64_t>(lane) * H + h;
  const int64_t lg = static_cast<int64_t>(lane) * G + g;
  for (int i = tid; i < p + 2 * n; i += kThreads) {
    if (i < p) {
      const int64_t t0 = static_cast<int64_t>(lane) * w1 * H * p + h * p + i;
      xs[i] = conv_channel<T, W>(static_cast<const T*>(a.tx) + t0,
                                 static_cast<T*>(a.tx_out) + t0, static_cast<int64_t>(H) * p,
                                 static_cast<const T*>(a.xh)[lh * p + i],
                                 static_cast<const W*>(a.wx) + h * p + i,
                                 static_cast<int64_t>(H) * p,
                                 a.bx ? static_cast<const W*>(a.bx) + h * p + i : nullptr, w,
                                 true);
    } else {
      const int j = i - p, which = j / n, c = j % n;
      const int64_t t0 = static_cast<int64_t>(lane) * w1 * G * n + g * n + c;
      const void* bias = which ? a.bc : a.bb;
      const float v = conv_channel<T, W>(
          static_cast<const T*>(which ? a.tc : a.tb) + t0,
          static_cast<T*>(which ? a.tc_out : a.tb_out) + t0, static_cast<int64_t>(G) * n,
          static_cast<const T*>(which ? a.C : a.B)[lg * n + c],
          static_cast<const W*>(which ? a.wc : a.wb) + g * n + c, static_cast<int64_t>(G) * n,
          bias ? static_cast<const W*>(bias) + g * n + c : nullptr, w, lead);
      (which ? cs : bs)[c] = v;
    }
  }
  const float dtv = softplus(__fadd_rn(a.dt[lh], a.dt_bias[h]));
  const float decay = expf(__fmul_rn(dtv, -expf(a.A_log[h])));
  cp_async_wait_all();
  __syncthreads();

  // 3. state <- state decay + (B dt) (x) x into state_out; C . state by rows
  float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
  if (holds) {
    const float4 xv = reinterpret_cast<const float4*>(xs)[col];
    float4* so = reinterpret_cast<float4*>(a.state_out + tile);
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int r = r0 + k * rpp;
      if (r >= n) break;
      const float bdt = __fmul_rn(bs[r], dtv), c = cs[r];
      float4 v = tile_s[r * c4 + col];
      v.x = __fadd_rn(__fmul_rn(v.x, decay), __fmul_rn(bdt, xv.x));
      v.y = __fadd_rn(__fmul_rn(v.y, decay), __fmul_rn(bdt, xv.y));
      v.z = __fadd_rn(__fmul_rn(v.z, decay), __fmul_rn(bdt, xv.z));
      v.w = __fadd_rn(__fmul_rn(v.w, decay), __fmul_rn(bdt, xv.w));
      __stcs(so + r * c4 + col, v);
      part.x = fmaf(c, v.x, part.x);
      part.y = fmaf(c, v.y, part.y);
      part.z = fmaf(c, v.z, part.z);
      part.w = fmaf(c, v.w, part.w);
    }
    red[tid] = part;
  }
  __syncthreads();

  // 4. y = C . state + D x over the threads' partial sums
  if (tid < p) {
    const float* rf = reinterpret_cast<const float*>(red);
    float acc = 0.0f;
    for (int r = 0; r < rpp; ++r) acc += rf[r * p + tid];
    acc = __fadd_rn(acc, __fmul_rn(xs[tid], a.D[h]));
    static_cast<T*>(a.y)[lh * p + tid] = from_f32<T>(acc);
  }
}

// The tile's shared memory is allowed once a kernel instance and device.
template <typename T, typename W>
int launch(const Args& a, int lanes, cudaStream_t stream) {
  static int allowed[kMaxDevices];
  const int smem = a.n * a.p * static_cast<int>(sizeof(float));
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(mamba_step_kernel<T, W>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed[dev] = smem;
  }
  mamba_step_kernel<T, W><<<dim3(a.heads, lanes), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mamba_step_fwd(const void* xh, const void* B, const void* C, const void* dt,
                              const void* tx, const void* tb, const void* tc,
                              const void* state, const void* wx, const void* wb,
                              const void* wc, const void* bx, const void* bb,
                              const void* bc, const void* A_log, const void* dt_bias,
                              const void* D, const void* active, void* state_out,
                              void* tx_out, void* tb_out, void* tc_out, void* y, int lanes,
                              int heads, int groups, int n, int p, int w, int dtype,
                              int wdtype, void* stream) {
  if (lanes < 0 || heads < 1 || groups < 1 || heads % groups != 0 || n < 1 ||
      n > kMaxN || p < 4 || p > kMaxP || p % 4 != 0 || w < 2 || w > kMaxW ||
      dtype < 0 || dtype > 1 || wdtype < 0 || wdtype > 1 || lanes > 65535 ||
      (bx == nullptr) != (bb == nullptr) || (bx == nullptr) != (bc == nullptr) ||
      ((tb_out == tb || tc_out == tc) && groups != heads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0) return 0;
  const Args a{xh, B, C, static_cast<const float*>(dt), tx, tb, tc,
               static_cast<const float*>(state), wx, wb, wc, bx, bb, bc,
               static_cast<const float*>(A_log), static_cast<const float*>(dt_bias),
               static_cast<const float*>(D), static_cast<const uint8_t*>(active),
               static_cast<float*>(state_out), tx_out, tb_out, tc_out, y,
               heads, groups, n, p, w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return wdtype == 1 ? launch<__nv_bfloat16, __nv_bfloat16>(a, lanes, s)
                       : launch<__nv_bfloat16, float>(a, lanes, s);
  return wdtype == 1 ? launch<float, __nv_bfloat16>(a, lanes, s) : launch<float, float>(a, lanes, s);
}
