// The Mamba-2 mixer's decode step for Hopper (sm_90a): one frame of one
// mixer layer for every stream of a batch, between the layer's in_proj
// (whose output zxbcdt = [z | xBC | dt] it reads) and its gated RMSNorm and
// out_proj (cuBLAS products outside).
//
// No TPU kernel of the JAX package computes this (the JAX package runs a
// Llama backbone only); the plain PyTorch version in
// csm_tpu_torch/ops/ssm.py::ssm_step_reference is the oracle, op for op:
//
//   window = [conv_state (d_conv - 1 = 3 rows) ; xBC]          (per channel)
//   xbc    = silu(conv_b + sum_k conv_w[:, k] * window[k])      (f32)
//   conv_state <- window[1:]
//   delta  = softplus(dt + dt_bias), A = -exp(A_log)            (per head)
//   S'     = exp(delta A) S + (delta x) (x) B                   (f32, [P, N])
//   y      = S' C + D x,   out = y * silu(z)                    (f32)
//   S <- S' in the activations' dtype (f32 or bf16)
//
// What bounds it is bytes: each head's state (P x N = 64 x 128, 16 KB in
// bf16) is read once and written once; at 64 heads, 36 layers and 32 streams
// that is 2.4 GB a frame step.  So the grid is one block per (head, stream),
// 8 warps; warp w owns rows p = w, w + 8, ... of the head's state, each lane
// 4 consecutive columns n of each 128-column chunk, so a warp's row is one
// coalesced access and a block has all its rows' loads in flight before it
// computes; registers are held to three blocks an SM.
// y's row sum over n is a warp reduction.
//
// The conv: a block computes the conv of the channels it needs (its head's
// P x channels and its group's N B and N C channels) from the old conv
// state.  It owns its x channels and shifts their state itself.  The B and C
// channels are read by every head's block of a stream, so none may shift
// them before all have read them: each block, after its reads, takes a
// ticket on its stream's counter (a __threadfence first), and the block that
// takes the last ticket shifts the B and C channels' state of every group
// and re-arms the counter to 0 for the next launch (launches on one stream
// run in order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KCONV = 4;            // d_conv
constexpr int MAX_ROWS = 8;         // rows a warp owns: P <= 64
constexpr int MIN_BLOCKS = 3;       // blocks an SM holds at once (registers)

constexpr int REFUSED_SHAPES = 10001;
constexpr int REFUSED_DTYPE = 10002;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four consecutive state values as f32, and back.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }
__device__ __forceinline__ float softplus(float v) {
  return v > 20.0f ? v : log1pf(expf(v));
}

struct Shapes {
  int H, P, N, G, C, inner, in_dim;
};

// The conv channel of a block's i-th needed channel: its head's x channels,
// then its group's B channels, then its group's C channels.
__device__ __forceinline__ int channel_of(int i, int h, int g, const Shapes& s) {
  if (i < s.P) return h * s.P + i;
  if (i < s.P + s.N) return s.inner + g * s.N + (i - s.P);
  return s.inner + s.G * s.N + g * s.N + (i - s.P - s.N);
}

// T: activations, conv state, recurrent state and the layer's parameters;
// NV: 128-column chunks of a state row (N = 128 NV).
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ssm_step_kernel(const T* __restrict__ zxbcdt, T* __restrict__ conv_state,
                const T* __restrict__ conv_w, const T* __restrict__ conv_b,
                const T* __restrict__ dt_bias, const T* __restrict__ a_log,
                const T* __restrict__ d_skip, T* __restrict__ state, float* __restrict__ y,
                int* __restrict__ counters, Shapes s) {
  extern __shared__ float smem[];
  float* xs = smem;             // [P]: the head's x after the conv
  float* bs = xs + s.P;         // [N]: its group's B
  float* cs = bs + s.N;         // [N]: its group's C
  __shared__ int last;

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (s.H / s.G);
  const T* row = zxbcdt + (size_t)b * s.in_dim;
  const T* xbc_in = row + s.inner;
  T* cst = conv_state + (size_t)b * (KCONV - 1) * s.C;  // [3, C]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  T* st = state + ((size_t)b * s.H + h) * s.P * s.N;
  // The head's state rows first: their loads are in flight while the conv
  // runs (neither reads the other's memory).
  float4 v[MAX_ROWS][NV];
#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    const int p = warp + r * WARPS;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (p < s.P) v[r][j] = load4(st + (size_t)p * s.N + j * 128 + lane * 4);
  }

  // The conv of the needed channels from the old state; the x channels'
  // state shifted at once (this block owns them).
  const int need = s.P + 2 * s.N;
  for (int i = threadIdx.x; i < need; i += THREADS) {
    const int c = channel_of(i, h, g, s);
    const float s0 = to_f(cst[c]), s1 = to_f(cst[s.C + c]), s2 = to_f(cst[2 * s.C + c]);
    const float xn = to_f(xbc_in[c]);
    const T* w = conv_w + (size_t)c * KCONV;
    // The plain version's order: bias, then the taps oldest first.
    float acc = to_f(conv_b[c]);
    acc += to_f(w[0]) * s0;
    acc += to_f(w[1]) * s1;
    acc += to_f(w[2]) * s2;
    acc += to_f(w[3]) * xn;
    smem[i] = silu(acc);
    if (i < s.P) {
      cst[c] = from_f<T>(s1);
      cst[s.C + c] = from_f<T>(s2);
      cst[2 * s.C + c] = xbc_in[c];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(&counters[b], 1) == s.H - 1;
  }

  const float delta = softplus(to_f(row[s.inner + s.C + h]) + to_f(dt_bias[h]));
  const float da = expf(delta * -expf(to_f(a_log[h])));
  const float dskip = to_f(d_skip[h]);

#pragma unroll
  for (int r = 0; r < MAX_ROWS; ++r) {
    const int p = warp + r * WARPS;
    if (p >= s.P) break;
    const float xp = xs[p];
    const float dx = delta * xp;
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int n = j * 128 + lane * 4;
      float4 q = v[r][j];
      q.x = da * q.x + dx * bs[n];
      q.y = da * q.y + dx * bs[n + 1];
      q.z = da * q.z + dx * bs[n + 2];
      q.w = da * q.w + dx * bs[n + 3];
      acc += q.x * cs[n] + q.y * cs[n + 1] + q.z * cs[n + 2] + q.w * cs[n + 3];
      store4(st + (size_t)p * s.N + n, q);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const float yp = acc + dskip * xp;
      const float z = to_f(row[h * s.P + p]);
      y[(size_t)b * s.inner + h * s.P + p] = yp * silu(z);
    }
  }

  // The last block of the stream shifts the B and C channels' conv state.
  __syncthreads();
  if (last) {
    for (int i = threadIdx.x; i < 2 * s.G * s.N; i += THREADS) {
      const int c = s.inner + i;
      const T s1 = cst[s.C + c], s2 = cst[2 * s.C + c];
      cst[c] = s1;
      cst[s.C + c] = s2;
      cst[2 * s.C + c] = xbc_in[c];
    }
    if (threadIdx.x == 0) counters[b] = 0;
  }
}

template <typename T, int NV>
int launch_nv(const void* zxbcdt, void* conv_state, const void* conv_w, const void* conv_b,
              const void* dt_bias, const void* a_log, const void* d_skip, void* state, void* y,
              void* counters, int B, const Shapes& s, cudaStream_t stream) {
  const dim3 grid(s.H, B);
  const size_t smem = sizeof(float) * (s.P + 2 * s.N);
  ssm_step_kernel<T, NV><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(zxbcdt), static_cast<T*>(conv_state), static_cast<const T*>(conv_w),
      static_cast<const T*>(conv_b), static_cast<const T*>(dt_bias),
      static_cast<const T*>(a_log), static_cast<const T*>(d_skip), static_cast<T*>(state),
      static_cast<float*>(y), static_cast<int*>(counters), s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* zxbcdt, void* conv_state, const void* conv_w, const void* conv_b,
           const void* dt_bias, const void* a_log, const void* d_skip, void* state, void* y,
           void* counters, int B, const Shapes& s, cudaStream_t stream) {
  if (s.N == 128)
    return launch_nv<T, 1>(zxbcdt, conv_state, conv_w, conv_b, dt_bias, a_log, d_skip,
                              state, y, counters, B, s, stream);
  return launch_nv<T, 2>(zxbcdt, conv_state, conv_w, conv_b, dt_bias, a_log, d_skip, state,
                            y, counters, B, s, stream);
}

}  // namespace

extern "C" {

// All tensors contiguous on the current device.  io_kind 0 (bf16) or 1
// (f32) types zxbcdt [B, in_dim], conv_state [B, 3, C] and state [B, H, P,
// N] (both updated in place), conv_w [C, 4], conv_b [C], dt_bias / a_log /
// d_skip [H]; y [B, inner] f32 out;
// counters: at least B int32, zero when first passed, re-armed by the
// kernel.  One launch on stream.  Returns 0, a cudaError_t, or a code of
// arguments the kernel refuses.
int ssm_step(const void* zxbcdt, void* conv_state, const void* conv_w, const void* conv_b,
             const void* dt_bias, const void* a_log, const void* d_skip, void* state, void* y,
             void* counters, int B, int H, int P, int N, int G, int C, int inner, int in_dim,
             int io_kind, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || G < 1 || H % G != 0 || P < 8 || P % 8 != 0 ||
      P > WARPS * MAX_ROWS || (N != 128 && N != 256) || inner != H * P ||
      C != inner + 2 * G * N || in_dim != inner + C + H)
    return REFUSED_SHAPES;
  const Shapes s{H, P, N, G, C, inner, in_dim};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (io_kind == 0)
    return launch<__nv_bfloat16>(zxbcdt, conv_state, conv_w, conv_b, dt_bias, a_log, d_skip,
                                 state, y, counters, B, s, st);
  if (io_kind == 1)
    return launch<float>(zxbcdt, conv_state, conv_w, conv_b, dt_bias, a_log, d_skip, state, y,
                         counters, B, s, st);
  return REFUSED_DTYPE;
}

const char* ssm_error_string(int code) {
  if (code == REFUSED_SHAPES)
    return "shapes the kernel does not take (P a multiple of 8 up to 64, N 128 or 256, "
           "G dividing H, C = H P + 2 G N, in_dim = H P + C + H)";
  if (code == REFUSED_DTYPE) return "dtypes the kernel does not take (bf16 or f32)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
