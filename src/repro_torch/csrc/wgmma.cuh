// The wgmma GEMM kernels' shared pieces (sm_90a): the wgmma.mma_async
// wrappers, the check of a tile plan from kernels/gemm.py
// `tensor_core_plan`, and the dispatch to the built (atom width, atoms)
// variants.  csrc/tc_tile.cuh (the dense GEMM) and csrc/grouped_gemm.cu (the
// stacked grouped GEMM) each have their own kernel around them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {
namespace tc {

constexpr int kMaxThreads = 4 * kWarpgroup;

// wgmma.mma_async m64nNk16, f32 += bf16 (A K-major, B N-major), on the
// 64 x N accumulator fragment d (N / 2 floats a thread).
template <int N> struct Wgmma;

template <> struct Wgmma<8> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <> struct Wgmma<16> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1)
        : "memory");
  }
};

// 0 when the plan (wm, wn, nw, atoms, stages, smem) describes the tile
// (bm, bn, bk) and its variant is built, cudaErrorInvalidValue otherwise.
// Every plan it admits has at most 4 warpgroups of at most 8 atoms, so a
// tile has at most 4 * 8 * 64 = 2048 rows.
inline int check_plan(int bm, int bn, int bk, int wm, int wn, int stages, int nw, int atoms,
                      int smem) {
  const int wgs = wm * wn;
  if (bm <= 0 || bn <= 0 || bk <= 0 || wm <= 0 || wn <= 0 || wgs > 4 || nw <= 0 ||
      bm % (64 * wm) || bn % (8 * wn) || bk % 16 || (bn / wn) % nw ||
      atoms != (bm / wm / 64) * (bn / wn / nw) || stages < 2 || stages > 4)
    return (int)cudaErrorInvalidValue;
  const int64_t stage = 2LL * ((int64_t)bm * bk + (int64_t)bk * bn);
  const int64_t stage_out = 2LL * bm * (bn + 8);
  const int64_t need = stages * stage > stage_out ? stages * stage : stage_out;
  if (smem < need || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (atoms > 8) return (int)cudaErrorInvalidValue;  // keeps the variant key unambiguous
  return 0;
}

// Returns go.template run<NW, A>() for the built variant (nw, atoms), or
// cudaErrorInvalidValue.  The variants (atom width, atoms a warpgroup) are
// those kernels/gemm.py lists as _TC_VARIANTS, for every wgmma GEMM kernel.
template <class Go>
int with_variant(int nw, int atoms, const Go& go) {
  switch (nw * 16 + atoms) {
    case 8 * 16 + 1: return go.template run<8, 1>();
    case 8 * 16 + 2: return go.template run<8, 2>();
    case 8 * 16 + 4: return go.template run<8, 4>();
    case 8 * 16 + 8: return go.template run<8, 8>();
    case 16 * 16 + 1: return go.template run<16, 1>();
    case 16 * 16 + 2: return go.template run<16, 2>();
    case 16 * 16 + 4: return go.template run<16, 4>();
    case 16 * 16 + 8: return go.template run<16, 8>();
    case 32 * 16 + 1: return go.template run<32, 1>();
    case 32 * 16 + 2: return go.template run<32, 2>();
    case 32 * 16 + 4: return go.template run<32, 4>();
    case 64 * 16 + 1: return go.template run<64, 1>();
    case 64 * 16 + 2: return go.template run<64, 2>();
    case 128 * 16 + 1: return go.template run<128, 1>();
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace
