// Tensor-core tile shared by csrc/gemm.cu and csrc/grouped_gemm.cu (sm_90a).
//
// One CTA computes one selected layer-1 tile (block_m, block_n, block_k) of
// out[g] = x[g] @ w[g / r] (G = 1, r = 1 for the plain GEMM) in bf16 with f32
// accumulation on the tensor cores:
//
// - Math.  wgmma.mma_async m64nNk16 (bf16 in, f32 out), A and B read from
//   shared memory through no-swizzle matrix descriptors.  The CTA has
//   wm x wn warpgroups (1-4); warpgroup (i, j) owns rows
//   [i, i + 1) * block_m / wm and columns [j, j + 1) * block_n / wn of the
//   tile, cut into `A` atoms of 64 x NW, each with its accumulator in
//   registers (A * NW / 2 floats a thread, at most 64 for the H100
//   lattice's tiles).  The host picks (wm, wn, NW, A) and the ring depth;
//   kernels/gemm.py `tensor_core_plan` is the one place that does so.
// - Copies.  A ring of `stages` (2-4) slots, each holding the bf16 A tile
//   (block_m x block_k) and B tile (block_k x block_n) of one k-step, filled
//   with 16-byte cp.async.  All slots are filled up front and slot kt is
//   refilled with k-step kt + stages as soon as every warpgroup's wgmma on
//   it has completed: k-steps kt + 1 .. kt + stages - 1 are in flight while
//   wgmma runs on slot kt.  Both tiles are stored as 8 x 8 core matrices of
//   128 contiguous bytes: chunk c (16 bytes) of A is row (c / 8kc) * 8 + c % 8,
//   k-chunk (c / 8) % kc (kc = block_k / 8) -- K-major; chunk c of B is
//   k-row ((c / 8) % kc) * 8 + c % 8, columns 8 * (c / 8kc) .. +8 -- N-major
//   (wgmma's transposed B).  So both descriptors step 128 bytes between
//   core matrices along K (LBO) and 16 * block_k bytes along M or N (SBO),
//   the 16 bytes a thread copies land at consecutive addresses (no bank
//   conflicts), and a warp reads whole 32-byte sectors of A.
// - Masking.  Rows of x at or past the live count (counts[g], or m_true
//   when counts is null) are never read: their slots are zero-filled by
//   plain shared stores on the slot's first fill only (they never change).
//   A 64-row atom that starts at or past the count issues no wgmma; a tile
//   that starts there skips the k loop.  Ragged K or N, or a row stride that
//   is not a multiple of 16 bytes, take element-wise predicated loads at
//   that edge.  The epilogue stages the bf16 tile in shared memory and
//   writes it coalesced, 16 bytes a thread; rows past the count are exact
//   zeros, rows past the tensor are not written.
// - Shared memory: max(stages * (block_m * block_k + block_k * block_n) * 2,
//   block_m * (block_n + 8) * 2) bytes, which never exceeds the tile's
//   priced footprint l1_tile_bytes (two streamed stages plus the f32
//   accumulator), so every tile the lattice admits launches.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {
namespace tc {

constexpr int kMaxThreads = 4 * kWarpgroup;

struct Args {
  const __nv_bfloat16* x;  // (G, rows, K) row-major
  const __nv_bfloat16* w;  // (G / r, K, N) row-major
  const int* counts;       // (G,) live rows per group, or null: m_true
  __nv_bfloat16* out;      // (G, rows, N)
  int rows, N, K, m_true, r, gm;
  int block_m, block_n, block_k;
  int wm, wn, stages;
  int vec_x, vec_w, vec_out;  // 16-byte copies allowed (aligned rows)
};

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

// Fills one ring slot with k-step k0 / block_k: the first a_rows rows of the
// A tile (the atoms that hold a live row) and the whole B tile.  A refill
// visits only the 8-row groups that hold a live row: the dead rows past
// them were zeroed by the slot's first fill and never change.
__device__ __forceinline__ void load_stage(const Args& p, unsigned char* a_s, unsigned char* b_s,
                                           const __nv_bfloat16* xg, const __nv_bfloat16* wg,
                                           int tile_m0, int tile_n0, int row_lim, int a_rows,
                                           int k0, bool first_fill) {
  const int kc = p.block_k >> 3;
  const int per_group = 8 * kc;  // chunks per 8-row (A) or 8-column (B) group
  // per_group = block_k: a shift when it is a power of two (every lattice
  // tile), a division otherwise.
  const bool pow2 = (per_group & (per_group - 1)) == 0;
  const int shift = __ffs(per_group) - 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int a_chunks = (first_fill ? a_rows : min(a_rows, (row_lim - tile_m0 + 7) & ~7)) * kc;
  for (int c = tid; c < a_chunks; c += nt) {
    const int grp = pow2 ? c >> shift : c / per_group;
    const int q = c - grp * per_group;
    const int gr = tile_m0 + grp * 8 + (q & 7);
    const int gk = k0 + (q >> 3) * 8;
    unsigned char* dst = a_s + c * 16;
    if (gr < row_lim && gk < p.K) {
      const __nv_bfloat16* src = xg + (int64_t)gr * p.K + gk;
      if (p.vec_x && gk + 8 <= p.K)
        cp_async16(smem_u32(dst), src);
      else
        load8_masked(dst, src, min(8, p.K - gk));
    } else if (gr < row_lim || first_fill) {
      store_zero16(dst);  // the K tail, or a dead row (constant: first fill only)
    }
  }
  const int b_chunks = p.block_k * (p.block_n >> 3);
  for (int c = tid; c < b_chunks; c += nt) {
    const int grp = pow2 ? c >> shift : c / per_group;
    const int q = c - grp * per_group;
    const int gk = k0 + (q >> 3) * 8 + (q & 7);
    const int gn = tile_n0 + grp * 8;
    unsigned char* dst = b_s + c * 16;
    if (gk < p.K && gn < p.N) {
      const __nv_bfloat16* src = wg + (int64_t)gk * p.N + gn;
      if (p.vec_w && gn + 8 <= p.N)
        cp_async16(smem_u32(dst), src);
      else
        load8_masked(dst, src, min(8, p.N - gn));
    } else {
      store_zero16(dst);
    }
  }
}

template <int NW, int A>
__global__ void __launch_bounds__(kMaxThreads) tc_gemm_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int g = blockIdx.x / p.gm;
  const int tile_m0 = (blockIdx.x - g * p.gm) * p.block_m;
  const int tile_n0 = blockIdx.y * p.block_n;
  const __nv_bfloat16* xg = p.x + (int64_t)g * p.rows * p.K;
  const __nv_bfloat16* wg = p.w + (int64_t)(g / p.r) * p.K * p.N;
  __nv_bfloat16* og = p.out + (int64_t)g * p.rows * p.N;
  // Broadcast from lane 0: the compiler then knows both values are uniform,
  // so the branches on them below keep the wgmma pipeline intact.
  const int lim = p.counts ? p.counts[g] : p.m_true;
  const int row_lim = __shfl_sync(0xffffffffu, max(0, min(p.rows, lim)), 0);
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / kWarpgroup, 0);
  const int rows_wg = p.block_m / p.wm, cols_wg = p.block_n / p.wn;
  const int atoms_n = cols_wg / NW;
  const int wg_r0 = (wgi % p.wm) * rows_wg, wg_c0 = (wgi / p.wm) * cols_wg;

  float acc[A][NW / 2];
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc[i][j] = 0.f;

  // Block-uniform: a tile wholly past the live rows skips the k loop.
  if (tile_m0 < row_lim) {
    const int a_rows = min(p.block_m, (row_lim - tile_m0 + 63) & ~63);
    const int a_bytes = p.block_m * p.block_k * 2;
    const int stage_bytes = a_bytes + p.block_k * p.block_n * 2;
    const int nk = (p.K + p.block_k - 1) / p.block_k;
    const uint32_t lbo = 128, sbo = 16u * p.block_k;
    bool live[A];
    uint32_t off_a[A], off_b[A];
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const int r0 = wg_r0 + (i / atoms_n) * 64, c0 = wg_c0 + (i % atoms_n) * NW;
      live[i] = tile_m0 + r0 < row_lim;  // warpgroup-uniform
      off_a[i] = (uint32_t)r0 * p.block_k * 2;
      off_b[i] = (uint32_t)c0 * p.block_k * 2;
    }
    // Slot kt % stages holds k-step kt.  Every slot is filled up front, and a
    // slot is refilled (k-step kt + stages) as soon as every warpgroup's
    // wgmma on it has completed, so `stages` k-steps are in flight while a
    // CTA waits and stages - 1 while it multiplies.
    for (int s = 0; s < p.stages; ++s) {
      if (s < nk) {
        unsigned char* st = tc_smem + s * stage_bytes;
        load_stage(p, st, st + a_bytes, xg, wg, tile_m0, tile_n0, row_lim, a_rows,
                   s * p.block_k, true);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait(p.stages - 1);  // this thread's copies of k-step kt landed
      fence_proxy_async();
      __syncthreads();  // everyone's copies of k-step kt landed
      // Descriptors of k-step kt's slot; each 16-deep slice of it sits 256
      // bytes (16 in the descriptor's address field) further along K.
      const uint32_t a_s = smem_u32(tc_smem + (kt % p.stages) * stage_bytes);
      const uint32_t b_s = a_s + a_bytes;
      uint64_t desc_a[A], desc_b[A];
#pragma unroll
      for (int i = 0; i < A; ++i) {
        desc_a[i] = make_desc(a_s + off_a[i], lbo, sbo);
        desc_b[i] = make_desc(b_s + off_b[i], lbo, sbo);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int j = 0; j < NW / 2; ++j) fence_operand(acc[i][j]);
      wgmma_fence();
      for (int kk = 0; kk < p.block_k / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < A; ++i) {
          if (live[i]) Wgmma<NW>::mma(acc[i], desc_a[i] + 16 * kk, desc_b[i] + 16 * kk);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int j = 0; j < NW / 2; ++j) fence_operand(acc[i][j]);
      const int nxt = kt + p.stages;
      if (nxt < nk) {
        __syncthreads();  // every warpgroup is done reading slot kt % stages
        unsigned char* st = tc_smem + (kt % p.stages) * stage_bytes;
        load_stage(p, st, st + a_bytes, xg, wg, tile_m0, tile_n0, row_lim, a_rows,
                   nxt * p.block_k, false);
      }
      cp_async_commit();
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // the ring is free: stage the bf16 tile through it

  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  const int ld = p.block_n + 8;  // +16 bytes a row: conflict-free fragment stores
  const int lane = threadIdx.x & 31, warp = (threadIdx.x % kWarpgroup) / 32;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const int r = wg_r0 + (i / atoms_n) * 64 + warp * 16 + (lane >> 2);
    const int c = wg_c0 + (i % atoms_n) * NW + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(so + r * ld + c + 8 * j) =
          __floats2bfloat162_rn(acc[i][4 * j], acc[i][4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(so + (r + 8) * ld + c + 8 * j) =
          __floats2bfloat162_rn(acc[i][4 * j + 2], acc[i][4 * j + 3]);
    }
  }
  __syncthreads();
  const int per_row = p.block_n >> 3;
  const int rows_out = min(p.block_m, p.rows - tile_m0);
  for (int c = threadIdx.x; c < rows_out * per_row; c += blockDim.x) {
    const int row = c / per_row, col = (c - row * per_row) * 8;
    const int gc = tile_n0 + col;
    if (gc >= p.N) continue;
    const __nv_bfloat16* src = so + row * ld + col;
    __nv_bfloat16* dst = og + (int64_t)(tile_m0 + row) * p.N + gc;
    if (p.vec_out && gc + 8 <= p.N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && gc + e < p.N; ++e) dst[e] = src[e];
    }
  }
}

template <int NW, int A>
int launch_variant(const Args& p, dim3 grid, int threads, int smem, cudaStream_t s) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        tc_gemm_kernel<NW, A>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  tc_gemm_kernel<NW, A><<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

// Launches the tile plan (wm, wn, nw, atoms, stages, smem) over G groups of
// p.gm m-tiles each: grid = (G * gm, cdiv(N, block_n)).  A plan that does
// not describe the tile, or a variant that is not built, is refused with
// cudaErrorInvalidValue before anything runs.
inline int launch(Args p, int G, int nw, int atoms, int smem, cudaStream_t s) {
  const int bm = p.block_m, bn = p.block_n, bk = p.block_k;
  const int wgs = p.wm * p.wn;
  if (bm <= 0 || bn <= 0 || bk <= 0 || p.wm <= 0 || p.wn <= 0 || wgs > 4 || nw <= 0 ||
      bm % (64 * p.wm) || bn % (8 * p.wn) || bk % 16 || (bn / p.wn) % nw ||
      atoms != (bm / p.wm / 64) * (bn / p.wn / nw) || p.stages < 2 || p.stages > 4)
    return (int)cudaErrorInvalidValue;
  const int64_t stage = 2LL * ((int64_t)bm * bk + (int64_t)bk * bn);
  const int64_t stage_out = 2LL * bm * (bn + 8);
  const int64_t need = p.stages * stage > stage_out ? p.stages * stage : stage_out;
  if (smem < need || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (atoms > 8) return (int)cudaErrorInvalidValue;  // keeps the variant key unambiguous
  const int64_t blocks_x = (int64_t)G * p.gm;
  const int blocks_y = (p.N + bn - 1) / bn;
  if (blocks_x > 2147483647LL || blocks_y > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)blocks_x, blocks_y);
  const int threads = wgs * kWarpgroup;
  switch (nw * 16 + atoms) {
    case 8 * 16 + 1: return launch_variant<8, 1>(p, grid, threads, smem, s);
    case 8 * 16 + 2: return launch_variant<8, 2>(p, grid, threads, smem, s);
    case 8 * 16 + 4: return launch_variant<8, 4>(p, grid, threads, smem, s);
    case 8 * 16 + 8: return launch_variant<8, 8>(p, grid, threads, smem, s);
    case 16 * 16 + 1: return launch_variant<16, 1>(p, grid, threads, smem, s);
    case 16 * 16 + 2: return launch_variant<16, 2>(p, grid, threads, smem, s);
    case 16 * 16 + 4: return launch_variant<16, 4>(p, grid, threads, smem, s);
    case 16 * 16 + 8: return launch_variant<16, 8>(p, grid, threads, smem, s);
    case 32 * 16 + 1: return launch_variant<32, 1>(p, grid, threads, smem, s);
    case 32 * 16 + 2: return launch_variant<32, 2>(p, grid, threads, smem, s);
    case 32 * 16 + 4: return launch_variant<32, 4>(p, grid, threads, smem, s);
    case 64 * 16 + 1: return launch_variant<64, 1>(p, grid, threads, smem, s);
    case 64 * 16 + 2: return launch_variant<64, 2>(p, grid, threads, smem, s);
    case 128 * 16 + 1: return launch_variant<128, 1>(p, grid, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace tc
}  // namespace
