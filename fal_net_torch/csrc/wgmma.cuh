// Warpgroup matrix multiply (wgmma) on Hopper (sm_90a) with A in registers,
// and the tensor-map encoder, for the two conv kernels: conv3x3_wgmma.cu
// (TF32, K3 and K4) and logits_conv.cu (bf16, L1).
//
// Both stage their weights as B, K-major in (N, 64-byte) tiles with the
// 64-byte swizzle, and read A from registers gathered out of the staged
// NCHW rows, so one descriptor form and one instruction form serve both:
// Wgmma<N, Tf32> (m64nNk8, 8 tf32 = 32 bytes of K) and Wgmma<N, Bf16>
// (m64nNk16, 16 bf16 = 32 bytes of K).  A k-step is 32 bytes of a tile's
// rows in either type, so the second step of a 64-byte row starts 32 bytes
// in.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ constexpr int round_up(int v, int a) { return (v + a - 1) / a * a; }

// The wgmma descriptor of a K-major operand in (N, 64-byte) tiles with the
// 64-byte swizzle: start address >> 4, leading offset unused by swizzled
// K-major layouts (1), stride offset 512 bytes between groups of 8 rows (32),
// layout type 2 (64-byte swizzle).  Tiles start on 1024-byte boundaries; the
// second k-step starts at +32 bytes, and the hardware applies the swizzle
// to the address it forms.
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int kPending> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(kPending) : "memory");
}

// D (64 x N, fp32, registers) += A (64 x one k-step, registers: four 32-bit
// registers a thread) * B (one k-step x N, shared memory through `desc`).
// Tf32: a register holds one tf32 value; Bf16: two bf16 values, the lower
// K index in the low half.  The bf16 form's last immediate, 0, reads B
// K-major (not transposed).
struct Tf32 {};
struct Bf16 {};
template <int N, class Op> struct Wgmma;

#define WG_SHAPE_Tf32 "k8.f32.tf32.tf32"
#define WG_IMM_Tf32 ", p, 1, 1;"
#define WG_SHAPE_Bf16 "k16.f32.bf16.bf16"
#define WG_IMM_Bf16 ", p, 1, 1, 0;"
#define WG_L4(a, b, c, d) "%" #a ", %" #b ", %" #c ", %" #d
#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_DEFINE_OP(N, OP, DREGS, A0, A1, A2, A3, DESC, ONE, ...)                                             \
  template <> struct Wgmma<N, OP> {                                                                          \
    __device__ __forceinline__ static void run(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t desc) {   \
      asm volatile(                                                                                          \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %" #ONE ", 0;\n"                                                 \
          "wgmma.mma_async.sync.aligned.m64n" #N WG_SHAPE_##OP " {" DREGS "}, {%" #A0 ", %" #A1 ", %" #A2  \
          ", %" #A3 "}, %" #DESC WG_IMM_##OP "\n}\n"                                                       \
          : __VA_ARGS__                                                                                      \
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));                                  \
    }                                                                                                        \
  };
#define WG_DEFINE(N, ...) WG_DEFINE_OP(N, Tf32, __VA_ARGS__) WG_DEFINE_OP(N, Bf16, __VA_ARGS__)

WG_DEFINE(8, WG_L4(0, 1, 2, 3), 4, 5, 6, 7, 8, 9, WG_D4(0))
WG_DEFINE(16, WG_L4(0, 1, 2, 3) ", " WG_L4(4, 5, 6, 7), 8, 9, 10, 11, 12, 13, WG_D4(0), WG_D4(4))
WG_DEFINE(24, WG_L4(0, 1, 2, 3) ", " WG_L4(4, 5, 6, 7) ", " WG_L4(8, 9, 10, 11), 12, 13, 14, 15, 16, 17,
          WG_D4(0), WG_D4(4), WG_D4(8))
WG_DEFINE(32,
          WG_L4(0, 1, 2, 3) ", " WG_L4(4, 5, 6, 7) ", " WG_L4(8, 9, 10, 11) ", " WG_L4(12, 13, 14, 15), 16, 17,
          18, 19, 20, 21, WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12))
WG_DEFINE(40,
          WG_L4(0, 1, 2, 3) ", " WG_L4(4, 5, 6, 7) ", " WG_L4(8, 9, 10, 11) ", " WG_L4(12, 13, 14, 15) ", " WG_L4(
              16, 17, 18, 19),
          20, 21, 22, 23, 24, 25, WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16))
WG_DEFINE(48,
          WG_L4(0, 1, 2, 3) ", " WG_L4(4, 5, 6, 7) ", " WG_L4(8, 9, 10, 11) ", " WG_L4(12, 13, 14, 15) ", " WG_L4(
              16, 17, 18, 19) ", " WG_L4(20, 21, 22, 23),
          24, 25, 26, 27, 28, 29, WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20))
WG_DEFINE(56,
          WG_L4(0, 1, 2, 3) ", " WG_L4(4, 5, 6, 7) ", " WG_L4(8, 9, 10, 11) ", " WG_L4(12, 13, 14, 15) ", " WG_L4(
              16, 17, 18, 19) ", " WG_L4(20, 21, 22, 23) ", " WG_L4(24, 25, 26, 27),
          28, 29, 30, 31, 32, 33, WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20), WG_D4(24))
WG_DEFINE(64,
          WG_L4(0, 1, 2, 3) ", " WG_L4(4, 5, 6, 7) ", " WG_L4(8, 9, 10, 11) ", " WG_L4(12, 13, 14, 15) ", " WG_L4(
              16, 17, 18, 19) ", " WG_L4(20, 21, 22, 23) ", " WG_L4(24, 25, 26, 27) ", " WG_L4(28, 29, 30, 31),
          32, 33, 34, 35, 36, 37, WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20), WG_D4(24),
          WG_D4(28))

#undef WG_DEFINE
#undef WG_DEFINE_OP
#undef WG_D4
#undef WG_L4
#undef WG_IMM_Bf16
#undef WG_SHAPE_Bf16
#undef WG_IMM_Tf32
#undef WG_SHAPE_Tf32

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime (no link
// against libcuda); nullptr where it is missing.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace
