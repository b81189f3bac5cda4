// PTX and synchronisation helpers shared by the port's persistent kernels
// (fused_decoder.cu, K2; bb_decode_q.cu, K1q-8 / K1q-4): cp.async copies,
// acquire / release words in device memory, mma.sync m16n8k16 bf16, the
// grid barrier and arrival waits of a cooperative launch, the global timer.
// A lost arrival traps after ~2^35 cycles (~17 s) instead of hanging the card.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sync_ptx {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most n (clamped to [0, 15]) groups of this thread are pending.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    case 7: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
    case 8: asm volatile("cp.async.wait_group 8;\n" ::: "memory"); break;
    case 9: asm volatile("cp.async.wait_group 9;\n" ::: "memory"); break;
    case 10: asm volatile("cp.async.wait_group 10;\n" ::: "memory"); break;
    case 11: asm volatile("cp.async.wait_group 11;\n" ::: "memory"); break;
    case 12: asm volatile("cp.async.wait_group 12;\n" ::: "memory"); break;
    case 13: asm volatile("cp.async.wait_group 13;\n" ::: "memory"); break;
    case 14: asm volatile("cp.async.wait_group 14;\n" ::: "memory"); break;
    default:
      if (n < 0) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      else asm volatile("cp.async.wait_group 15;\n" ::: "memory");
      break;
  }
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned add_release(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.release.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}
__device__ __forceinline__ unsigned add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], %2;\n"
               : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// D (+)= A B, m16n8k16, bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Grid-wide barrier (every block is resident: cooperative launch).  bar[0]
// counts arrivals and is reset by the last one, which then advances the
// generation bar[1].  A waiting block polls every ~100 ns: polling without
// pause floods the L2 slice of the barrier words and slows every other
// block's loads.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = ld_acquire(bar + 1);
    if (add_release(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      add_release(bar + 1, 1u);
    } else if (ld_acquire(bar + 1) == gen) {
      const long long t0 = clock64();
      do {
        __nanosleep(100);
        if (clock64() - t0 > (1ll << 35)) __trap();
      } while (ld_acquire(bar + 1) == gen);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Whether counter value v has reached target, modulo 2^32 (counters and
// epochs may wrap; they never lag by 2^31).
__device__ __forceinline__ bool reached(unsigned v, unsigned target) {
  return (int)(v - target) >= 0;
}

// Waits until *ctr reaches target (thread 0 polls as grid_sync does; the
// block follows).
__device__ __forceinline__ void wait_count(const unsigned* ctr, unsigned target) {
  if (threadIdx.x == 0 && !reached(ld_acquire(ctr), target)) {
    const long long t0 = clock64();
    do {
      __nanosleep(100);
      if (clock64() - t0 > (1ll << 35)) __trap();
    } while (!reached(ld_acquire(ctr), target));
  }
  __syncthreads();
}

}  // namespace sync_ptx
