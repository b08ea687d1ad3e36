// PTX helpers for Hopper (sm_90a) shared by the port's CUDA sources: mbarriers, TMA, wgmma
// descriptors, fences and instantiations (bf16 and tf32), and the tensor-map encoder with its
// cache.
// Included by resblock.cu (K1) and fused_infer.cu (K2); _build.py hashes it into both libraries.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of `bar` with parity `parity` has completed. A wait that lasts ~10 s
// (a fault in the ring's bookkeeping) traps, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > (1ll << 34)) {
      __trap();
    }
  }
}

// TMA: the box of `map` at (c0 along the contiguous dimension, c1 along the rows) into shared
// memory at dst; its bytes count towards bar's transaction count.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A wgmma shared-memory descriptor for a swizzled tile: start address, leading and stride byte
// offsets (16-byte units), layout type `swizzle` (1: the 128-byte swizzle, 2: the 64-byte one).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the wgmma fences and waits.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x n) += A (64 x 16) B (16 x n)^T, bf16 from shared memory; TA / TB: the operand is
// contiguous along M / N (wgmma's transpose bits) instead of along K. accumulate = 0 overwrites
// d (scale-d = 0), as wgmma_tf32's.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db,
                                      int accumulate = 1);

#define K1_WGMMA_64(TA, TB)                                                                   \
  template <>                                                                                 \
  __device__ __forceinline__ void wgmma<64, TA, TB>(float(&d)[32], uint64_t da, uint64_t db,  \
                                                        int accumulate) {                     \
    asm volatile(                                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                          \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                               \
        "{%0, %1, %2, %3, %4, %5, %6, %7, "                                                   \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                                              \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                                            \
        "%24, %25, %26, %27, %28, %29, %30, %31}, "                                           \
        "%32, %33, p, 1, 1, %35, %36;\n}\n"                                                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
          "+f"(d[31])                                                                         \
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));                               \
  }

#define K1_WGMMA_128(TA, TB)                                                                  \
  template <>                                                                                 \
  __device__ __forceinline__ void wgmma<128, TA, TB>(float(&d)[64], uint64_t da, uint64_t db, \
                                                         int accumulate) {                    \
    asm volatile(                                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                          \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                              \
        "{%0, %1, %2, %3, %4, %5, %6, %7, "                                                   \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                                              \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                                            \
        "%24, %25, %26, %27, %28, %29, %30, %31, "                                            \
        "%32, %33, %34, %35, %36, %37, %38, %39, "                                            \
        "%40, %41, %42, %43, %44, %45, %46, %47, "                                            \
        "%48, %49, %50, %51, %52, %53, %54, %55, "                                            \
        "%56, %57, %58, %59, %60, %61, %62, %63}, "                                           \
        "%64, %65, p, 1, 1, %67, %68;\n}\n"                                                   \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),          \
          "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),       \
          "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),       \
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),       \
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),       \
          "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),       \
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),       \
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                               \
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));                               \
  }

#define HOPPER_WGMMA_16(TA, TB)                                                               \
  template <>                                                                                 \
  __device__ __forceinline__ void wgmma<16, TA, TB>(float(&d)[8], uint64_t da, uint64_t db,   \
                                                       int accumulate) {                      \
    asm volatile(                                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                                          \
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "                               \
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "                                                  \
        "%8, %9, p, 1, 1, %11, %12;\n}\n"                                                     \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), \
          "+f"(d[7])                                                                          \
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));                               \
  }

#define HOPPER_WGMMA_256(TA, TB)                                                              \
  template <>                                                                                 \
  __device__ __forceinline__ void wgmma<256, TA, TB>(float(&d)[128], uint64_t da,            \
                                                         uint64_t db, int accumulate) {     \
    asm volatile(                                                                             \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                         \
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "                              \
        "{%0, %1, %2, %3, %4, %5, %6, %7, "                                                   \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                                              \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                                            \
        "%24, %25, %26, %27, %28, %29, %30, %31, "                                            \
        "%32, %33, %34, %35, %36, %37, %38, %39, "                                            \
        "%40, %41, %42, %43, %44, %45, %46, %47, "                                            \
        "%48, %49, %50, %51, %52, %53, %54, %55, "                                            \
        "%56, %57, %58, %59, %60, %61, %62, %63, "                                            \
        "%64, %65, %66, %67, %68, %69, %70, %71, "                                            \
        "%72, %73, %74, %75, %76, %77, %78, %79, "                                            \
        "%80, %81, %82, %83, %84, %85, %86, %87, "                                            \
        "%88, %89, %90, %91, %92, %93, %94, %95, "                                            \
        "%96, %97, %98, %99, %100, %101, %102, %103, "                                        \
        "%104, %105, %106, %107, %108, %109, %110, %111, "                                    \
        "%112, %113, %114, %115, %116, %117, %118, %119, "                                    \
        "%120, %121, %122, %123, %124, %125, %126, %127}, "                                   \
        "%128, %129, p, 1, 1, %131, %132;\n}\n"                                               \
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),             \
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),           \
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),       \
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),       \
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),       \
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),       \
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),       \
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),       \
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),       \
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),       \
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),       \
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),       \
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),       \
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),       \
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),       \
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),     \
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), \
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), \
          "+f"(d[126]), "+f"(d[127])                                                          \
        : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));                               \
  }

HOPPER_WGMMA_16(0, 0)
K1_WGMMA_64(0, 0)
K1_WGMMA_64(0, 1)
K1_WGMMA_64(1, 1)
K1_WGMMA_128(0, 0)
K1_WGMMA_128(0, 1)
K1_WGMMA_128(1, 1)
HOPPER_WGMMA_256(0, 0)
HOPPER_WGMMA_256(0, 1)
HOPPER_WGMMA_256(1, 1)

// d (m64 x n) += A (64 x 8) B (8 x n)^T, tf32 from shared memory, both operands K-major (wgmma
// has no transpose bits for tf32). A tf32 operand is a 32-bit word; the tensor core reads its
// top 19 bits (sign, exponent, 10 mantissa bits), so an f32 handed over as it is enters as its
// value with the low 13 mantissa bits cleared (chip_smoke.py checks that on the card).
// accumulate = 0 overwrites d (scale-d = 0), so no other instruction need write d while
// wgmmas are in flight: ptxas would then serialize them.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint64_t da, uint64_t db,
                                           int accumulate = 1);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

struct MapKey {
  const void* plane;
  int rows, cols, box_rows, chunk, box_cols;
  bool operator==(const MapKey& o) const {
    return plane == o.plane && rows == o.rows && cols == o.cols && box_rows == o.box_rows &&
           chunk == o.chunk && box_cols == o.box_cols;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    return std::hash<const void*>()(k.plane) ^ (static_cast<size_t>(k.rows) << 20) ^
           (static_cast<size_t>(k.cols) << 40) ^ static_cast<size_t>(k.box_rows) ^
           (static_cast<size_t>(k.chunk) << 56) ^ (static_cast<size_t>(k.box_cols) << 10);
  }
};

// The map of a row-major plane (rows x cols): of bf16 (chunk = 0) in 2D boxes of box_cols (64,
// in the 128-byte swizzle, or 32, in the 64-byte one) columns x box_rows rows; of f32 (chunk >=
// 1) viewed as (32 columns, rows, cols / 32 K tiles), in 3D boxes of 32 x box_rows x chunk in the
// 128-byte swizzle, which land as `chunk` consecutive K tiles of box_rows rows of 128 bytes. What
// lies outside the plane reads as zeros. A map is a function of these six values alone, so maps
// are kept by them: the caching allocator hands a training step the same addresses step after
// step, and an encode costs the host more than a launch.
cudaError_t plane_map(CUtensorMap* map, const void* plane, int rows, int cols, int box_rows,
                      int chunk = 0, int box_cols = 64) {
  static std::mutex mutex;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key = {plane, rows, cols, box_rows, chunk, box_cols};
  {
    std::lock_guard<std::mutex> lock(mutex);
    const auto hit = maps.find(key);
    if (hit != maps.end()) {
      *map = hit->second;
      return cudaSuccess;
    }
  }
  const EncodeTiled fn = encoder();
  if (!fn) return cudaErrorNotSupported;
  const bool f32 = chunk > 0;
  const cuuint64_t rows64 = static_cast<cuuint64_t>(rows), cols64 = static_cast<cuuint64_t>(cols);
  const cuuint64_t dims[3] = {f32 ? 32 : cols64, rows64, cols64 / 32};
  const cuuint64_t strides[2] = {cols64 * (f32 ? 4 : 2), 128};
  const cuuint32_t box[3] = {f32 ? 32u : static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), static_cast<cuuint32_t>(chunk)};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = fn(map, type, f32 ? 3 : 2, const_cast<void*>(plane), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        !f32 && box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mutex);
  if (maps.size() >= 4096) maps.clear();  // bounds the cache across many shapes and addresses
  maps.emplace(key, *map);
  return cudaSuccess;
}

}  // namespace
