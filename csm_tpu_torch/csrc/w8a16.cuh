// Small device helpers shared by the port's W8A16 / W4A16 kernels
// (bb_decode_q.cu, the int8 and int4 backbone steps; fused_decoder.cu, the
// codebook loop): the block size, bf16 rounding of an f32 value, warp sums
// and maxima in a fixed order, and the finite mask value of attention.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace w8a16 {

typedef __nv_bfloat16 bf16;

constexpr int NT = 256;             // threads per block
constexpr int NWARP = NT / 32;
constexpr float NEG_INF = -1e9f;

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace w8a16
