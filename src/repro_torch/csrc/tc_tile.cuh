// Tensor-core tile of csrc/gemm.cu (sm_90a) on a cp.async ring: the path of
// operands that csrc/tc_tma.cuh's TMA kernel cannot address (a row stride
// off 16 bytes, a pointer off 16 bytes, a tile whose boxes fit no layout;
// kernels/gemm.py `tma_plan`).  The wgmma wrappers, the plan check and the
// built variants are csrc/wgmma.cuh's, which the stacked grouped kernel
// (csrc/grouped_gemm.cu) shares; its tile loop is its own.
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

#include "wgmma.cuh"

namespace {
namespace tc {

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

struct DenseLaunch {
  const Args& p;
  dim3 grid;
  int threads, smem;
  cudaStream_t s;
  template <int NW, int A> int run() const {
    return launch_variant<NW, A>(p, grid, threads, smem, s);
  }
};

// Launches the tile plan (wm, wn, nw, atoms, stages, smem) over G groups of
// p.gm m-tiles each: grid = (G * gm, cdiv(N, block_n)).  A plan that does
// not describe the tile, or a variant that is not built, is refused with
// cudaErrorInvalidValue before anything runs.
inline int launch(Args p, int G, int nw, int atoms, int smem, cudaStream_t s) {
  if (const int e = check_plan(p.block_m, p.block_n, p.block_k, p.wm, p.wn, p.stages, nw,
                               atoms, smem))
    return e;
  const int64_t blocks_x = (int64_t)G * p.gm;
  const int blocks_y = (p.N + p.block_n - 1) / p.block_n;
  if (blocks_x > 2147483647LL || blocks_y > 65535) return (int)cudaErrorInvalidConfiguration;
  return with_variant(nw, atoms, DenseLaunch{p, dim3((unsigned)blocks_x, blocks_y),
                                             p.wm * p.wn * kWarpgroup, smem, s});
}

}  // namespace tc
}  // namespace
