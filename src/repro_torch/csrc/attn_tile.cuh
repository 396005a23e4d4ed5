// Device helpers of the tensor-core attention kernel (csrc/attention_tc.cu).
//
// The GEMMs' wgmma helpers (csrc/wgmma.cuh) are fixed to one form: A and B
// from shared-memory descriptors, A K-major, B N-major.  Attention needs two
// others:
//
// - S = Q K^T.  K is stored (keys, d) with d contiguous: B is K-MAJOR, so
//   the instruction takes imm-trans-b = 0 (`wgmma_ss16`).
// - O += P V.  P comes from the S accumulator in registers, cast to bf16 and
//   packed in pairs; V is stored (keys, d) with d contiguous: B is N-major
//   (imm-trans-b = 1), and A is the register operand {a0, a1, a2, a3}
//   (`WgmmaRS<N>`).
//
// The m64nNk16 accumulator fragment of a 16-key chunk (8 floats a thread:
// d[4j + e] is row warp*16 + lane/4 + 8*(e >= 2), key 8j + 2*(lane%4) + e%2)
// is, pair for pair, the A-register fragment of an m64k16 operand (a0 = row
// r, keys 2c..2c+1; a1 = row r+8, same keys; a2 = row r, keys 8+2c..; a3 =
// row r+8, keys 8+2c..), so P never goes through shared memory.
//
// Shared-memory layouts (no swizzle, 8 x 8 core matrices of 128 bytes):
//
// - K-major (Q and K tiles): the 16-byte chunk of row r, d-chunk dc sits at
//   chunk index (r/8)*8*kc + dc*8 + r%8 (kc = dp/8, dp the head width
//   rounded up to wgmma's k16; the chunks past d are zero).  Core matrices
//   step 128 bytes along d (LBO) and 16*dp bytes along the rows (SBO).
// - N-major (V tiles of `keys` rows): the chunk of key row kr, d-chunk dc
//   sits at chunk index dc*keys + kr.  Core matrices step 128 bytes along
//   the keys, which are wgmma's K (LBO), and 16*keys bytes along d, which
//   is its N (SBO).
//
// The copy, fence and descriptor primitives are csrc/sm90.cuh's, shared with
// the GEMMs' wgmma.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// Two floats rounded to bf16 and packed low-first: one A-register of wgmma.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d (64 x 16 f32 fragment) += A (descriptor, K-major) * B (descriptor,
// K-major: imm-trans-b = 0).
__device__ __forceinline__ void wgmma_ss16(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// d (64 x N f32 fragment) += A (registers, bf16x2) * B (descriptor, N-major:
// imm-trans-b = 1).
template <int N> struct WgmmaRS;

template <> struct WgmmaRS<8> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  }
};

template <> struct WgmmaRS<16> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  }
};

template <> struct WgmmaRS<64> {
  static __device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
        : "memory");
  }
};

}  // namespace
