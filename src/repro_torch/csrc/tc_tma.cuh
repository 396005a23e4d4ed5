// The dense tensor-core GEMM of csrc/gemm.cu (sm_90a): C[M,N] = A[M,K] @ B[K,N]
// in bf16 with f32 accumulation, fed by the Tensor Memory Accelerator.
//
// Replaces the Pallas TPU kernel `vortex_gemm` / `_gemm_kernel`
// (src/repro/kernels/gemm.py) on its tensor-core path: rows at or past the
// runtime live count read as zero (the pad tail may hold NaN), K/N tails
// masked, the selected layer-1 tile (block_m, block_n, block_k) honoured
// verbatim as one CTA's output tile, the k reduction walked in block_k steps
// inside the CTA.  Operands TMA cannot address (a row stride that is not a
// multiple of 16 bytes, a pointer off 16 bytes, a tile whose boxes fit no
// layout wgmma reads) take the cp.async kernel of csrc/tc_tile.cuh;
// kernels/gemm.py `tma_plan` decides, before the launch.
//
// What bounds it on this card.  The engine's tall tiles read far more than
// they compute: (512, 32, 64), the tile the H100 lattice serves for every
// projection of a phi4-mini layer past a few hundred rows, reads 64 KiB of A
// and 4 KiB of B from L2 a k-step for 2.1 MFLOP, about 30 FLOP a byte, and
// every CTA along N reads the same A again.  At the L2's 5.5-7 TB/s that
// caps the tile near 165-210 TFLOP/s, a sixth of the tensor cores' 989.
// Measured on an H100 SXM at 700 W, the tile runs at 150-220 TFLOP/s at the
// stream's shapes whether A comes from L2 or from the multicast: each SM
// takes in about 27 bytes a clock, so the bytes one SM receives bind, and
// the multicast gains only where A outgrows L2 (1-14% at M >= 4,096).
// Each part of the design answers a part of that:
//
// - A producer warp and an mbarrier ring.  One thread of a separate warp
//   (its registers given back with setmaxnreg) issues cp.async.bulk.tensor
//   loads of the A and B boxes of each k-step into a ring of `stages` slots,
//   as many as fit in a block's shared memory; slot s has a `full` barrier
//   (the producer's expect_tx plus the bytes TMA delivers) and an `empty`
//   one (one arrival from each consumer warpgroup of the cluster).  The
//   consumer warpgroups wait on `full`, issue their wgmmas and keep one
//   wgmma group in flight (wait_group 1): a slot is released once the group
//   that read it has retired.  No __syncthreads in the k loop, no thread
//   spends instructions or registers on copies, and stages - 1 k-steps are
//   in flight while one is multiplied.
// - Swizzled shared memory.  Each box is stored with the widest swizzle its
//   inner extent allows (128 B for A at block_k >= 64; 64 B for B at
//   block_n = 32; none for B's 16-byte rows at block_n = 8), and the wgmma
//   descriptors name the same layout: A K-major (rows of 32-128 bytes,
//   8-row groups SBO apart, a 16-deep slice 32 bytes further along the row),
//   B N-major (8-row groups SBO apart along K, 64-column boxes LBO apart
//   along N; unswizzled, 8 x 8 core matrices LBO apart along K).  A is cut
//   into boxes of at most 256 rows and 64 columns, B into boxes of at most
//   64 columns and 256 rows.
// - Masking by the map.  A's tensor map has the live count as its row
//   extent and both maps end at K and N, so TMA zero-fills every row, column
//   and k past them: rows at or past the count are never read.  A 64-row
//   atom that starts at or past the count issues no wgmma, a box with no
//   live atom is not loaded, and a tile that starts there skips the k loop.
//   The epilogue stages the bf16 tile in the ring and writes it coalesced,
//   16 bytes a thread; rows past the count are exact zeros, rows past the
//   tensor are not written.  A launch with no live row gets no A map.
// - A multicast across a cluster along N.  Where the tile is tall
//   (block_m >= 4 block_n) and the N tiles pair up, clusters of (1, 2, 1)
//   CTAs share an m-tile: each CTA loads half of A's boxes and TMA delivers
//   every box to both, so L2 serves A once per pair; B stays per CTA.  A
//   slot's `empty` barrier then counts both CTAs' consumers, and a producer
//   stays until every consumer of the cluster has released every slot.
//
// Shared memory: 1 KiB of alignment slack, max(stages * stage,
// block_m * (block_n + 8) * 2) bytes of ring (a stage is the bf16 A and B
// tiles of one k-step, rounded up to 1 KiB), and 16 bytes of barriers a
// stage; kernels/gemm.py `tma_plan` picks the largest `stages` that fits.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {
namespace tc {
namespace tma {

constexpr int kProducer = 32;   // one warp issues every load
constexpr int kAlign = 1024;    // a 128-byte swizzle repeats every 8 rows of 128 bytes
constexpr int kBoxMax = 256;    // TMA's largest box edge
constexpr int kMaxCluster = 2;  // a CTA and its peer

struct Args {
  __nv_bfloat16* out;  // (rows, N)
  int rows, N, K, m_live;
  int block_m, block_n, block_k;
  int wm, wn, stages, cluster, box_m;
  int vec_out;  // 16-byte output stores allowed (aligned rows)
};

// The box geometry every part of a launch derives from the tile alone.
struct Boxes {
  int a_k, a_kboxes, a_row;      // A: box columns, boxes along K, bytes a smem row
  int b_n, b_nboxes, b_k, b_row; // B: box columns, boxes along N, box rows, bytes a row
  int a_bytes, b_bytes, stage;   // a stage's A and B tiles, the stage rounded to kAlign

  __host__ __device__ static int swizzled(int elems) {
    return elems == 16 || elems == 32 || elems == 64;  // 32-, 64-, 128-byte rows
  }
  __host__ __device__ Boxes(int bm, int bn, int bk) {
    a_k = bk < 64 ? bk : 64;
    a_kboxes = bk / a_k;
    a_row = 2 * a_k;
    b_n = bn < 64 ? bn : 64;
    b_nboxes = bn / b_n;
    b_k = bk < kBoxMax ? bk : kBoxMax;
    b_row = 2 * b_n;
    a_bytes = 2 * bm * bk;
    b_bytes = 2 * bk * bn;
    stage = (a_bytes + b_bytes + kAlign - 1) / kAlign * kAlign;
  }
  // 0 when TMA boxes and the layouts wgmma reads cover the tile exactly.
  __host__ __device__ int check(int bn, int bk) const {
    return swizzled(a_k) && bk % a_k == 0 && (swizzled(b_n) || b_n == 8) && bn % b_n == 0 &&
                   bk % b_k == 0
               ? 0
               : (int)cudaErrorInvalidValue;
  }
};

// Shared-memory bytes of a plan with `stages` slots (mirrors kernels/gemm.py).
inline int64_t smem_bytes(int bm, int bn, int bk, int stages) {
  const Boxes x(bm, bn, bk);
  const int64_t ring = (int64_t)stages * x.stage;
  const int64_t epi = 2LL * bm * (bn + 8);
  return kAlign + (ring > epi ? ring : epi) + 16LL * stages;
}

// ---------------------------------------------------------------------------
// PTX: mbarriers, TMA, clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One arrival on the barrier at the same offset in CTA `rank` of the
// cluster.  The wgmma reads it releases have completed (wait_group), so the
// arrival needs no fence beyond the CTA's.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int x,
                                         int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y)
      : "memory");
}

// The box lands at offset `dst` in every CTA of `mask`, each CTA's barrier
// at offset `bar` counting its bytes.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int x, int y, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a box with rows of `row_bytes`: layout
// 1 = 128-byte swizzle, 2 = 64, 3 = 32, 0 = none (16-byte rows); base
// offset 0 (every swizzle atom starts kAlign-aligned).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : row_bytes == 32 ? 3 : 0;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (layout << 62);
}

// ---------------------------------------------------------------------------
// The kernel: wm x wn consumer warpgroups, then the producer warp
// ---------------------------------------------------------------------------

template <int NW, int A>
__global__ void __launch_bounds__(kMaxThreads + kProducer, 1)
    tc_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b, const Args p) {
  extern __shared__ unsigned char tma_smem[];
  const uint32_t raw = smem_u32(tma_smem);
  const uint32_t ring = (raw + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const Boxes x(p.block_m, p.block_n, p.block_k);
  // The ring, which the epilogue reuses, then full[s] = full0 + 8 s and
  // empty[s] = empty0 + 8 s.
  const uint32_t full0 =
      ring + (uint32_t)max(p.stages * x.stage, 2 * p.block_m * (p.block_n + 8));
  const uint32_t empty0 = full0 + 8u * p.stages;
  const int consumers = p.wm * p.wn * kWarpgroup;
  const int tile_m0 = blockIdx.x * p.block_m;
  const int tile_n0 = blockIdx.y * p.block_n;
  const int row_lim = __shfl_sync(0xffffffffu, max(0, min(p.rows, p.m_live)), 0);
  const int nk = (p.K + p.block_k - 1) / p.block_k;
  // Block-uniform (and cluster-uniform: a cluster shares its m-tile).
  const bool live_tile = tile_m0 < row_lim;
  // Rows of the tile in atoms that hold a live row; boxes past them stay unloaded.
  const int a_rows = min(p.block_m, (row_lim - tile_m0 + 63) & ~63);

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, (consumers / kWarpgroup) * p.cluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Every CTA of the cluster has its barriers before any CTA reaches them.
  if (p.cluster > 1)
    cluster_sync();
  else
    __syncthreads();

  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / kWarpgroup, 0);
  if (threadIdx.x >= consumers) {
    // ---- producer: one warp, one thread issuing -------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (live_tile && (threadIdx.x & 31) == 0) {
      prefetch_map(&map_a);
      prefetch_map(&map_b);
      const int rank = p.cluster > 1 ? (int)cluster_rank() : 0;
      const int mboxes = (a_rows + p.box_m - 1) / p.box_m;
      const int a_boxes = mboxes * x.a_kboxes;
      const uint32_t tx = (uint32_t)(a_boxes * p.box_m * x.a_row + x.b_bytes);
      const uint16_t mask = (uint16_t)((1u << p.cluster) - 1);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % p.stages, use = kt / p.stages;
        if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, tx);
        const uint32_t a_s = ring + (uint32_t)s * x.stage;
        const int k0 = kt * p.block_k;
        // A's boxes of this k-step, split over the cluster and delivered to all of it.
        for (int j = rank; j < a_boxes; j += p.cluster) {
          const int kb = j / mboxes, mb = j - kb * mboxes;
          const uint32_t dst = a_s + (uint32_t)(kb * p.block_m + mb * p.box_m) * x.a_row;
          if (p.cluster > 1)
            tma_load_multicast(dst, &map_a, full, k0 + kb * x.a_k, tile_m0 + mb * p.box_m, mask);
          else
            tma_load(dst, &map_a, full, k0 + kb * x.a_k, tile_m0 + mb * p.box_m);
        }
        // B's boxes: 64-column strips along N, each block_k rows deep.
        const uint32_t b_s = a_s + x.a_bytes;
        for (int nb = 0; nb < x.b_nboxes; ++nb)
          for (int kb = 0; kb < p.block_k; kb += x.b_k)
            tma_load(b_s + (uint32_t)(nb * p.block_k + kb) * x.b_row, &map_b, full,
                     tile_n0 + nb * x.b_n, k0 + kb);
      }
      // Peers arrive on this CTA's barriers: stay until every slot's last
      // use has been released by every consumer of the cluster.
      if (p.cluster > 1) {
        for (int kt = max(0, nk - p.stages); kt < nk; ++kt)
          mbar_wait(empty0 + 8 * (kt % p.stages), (kt / p.stages) & 1);
      }
    }
  } else {
    // ---- consumers: wm x wn warpgroups, A atoms of 64 x NW each ----------
    const int rows_wg = p.block_m / p.wm, cols_wg = p.block_n / p.wn;
    const int atoms_n = cols_wg / NW;
    const int wg_r0 = (wgi % p.wm) * rows_wg, wg_c0 = (wgi / p.wm) * cols_wg;
    float acc[A][NW / 2];
#pragma unroll
    for (int i = 0; i < A; ++i)
#pragma unroll
      for (int j = 0; j < NW / 2; ++j) acc[i][j] = 0.f;

    if (live_tile) {
      const int spa = x.a_k / 16;  // 16-deep slices in one A box row
      const uint32_t sbo_a = 8u * x.a_row, lbo_a = 16;
      // Swizzled, LBO steps between 64-column boxes and SBO between 8-row
      // groups along K; unswizzled (8-column B), the other way round.
      const bool b_swz = x.b_row > 16;
      const uint32_t b_group = 8u * x.b_row, b_strip = (uint32_t)p.block_k * x.b_row;
      const uint32_t lbo_b = b_swz ? b_strip : b_group, sbo_b = b_swz ? b_group : b_strip;
      bool live[A];
      uint32_t off_a[A], off_b[A];
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const int r0 = wg_r0 + (i / atoms_n) * 64, c0 = wg_c0 + (i % atoms_n) * NW;
        live[i] = tile_m0 + r0 < row_lim;  // warpgroup-uniform
        off_a[i] = (uint32_t)r0 * x.a_row;
        const int nb = c0 / x.b_n;
        off_b[i] = (uint32_t)(nb * p.block_k) * x.b_row + (uint32_t)(c0 - nb * x.b_n) * 2;
      }
      // One thread a warpgroup releases a slot, here and in the peer.
      const bool signal = threadIdx.x % kWarpgroup == 0;
      const uint32_t peer = p.cluster > 1 ? cluster_rank() ^ 1u : 0u;
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % p.stages;
        mbar_wait(full0 + 8 * s, (kt / p.stages) & 1);
        const uint32_t a_s = ring + (uint32_t)s * x.stage;
        const uint32_t b_s = a_s + x.a_bytes;
#pragma unroll
        for (int i = 0; i < A; ++i)
#pragma unroll
          for (int j = 0; j < NW / 2; ++j) fence_operand(acc[i][j]);
        wgmma_fence();
        for (int kk = 0; kk < p.block_k / 16; ++kk) {
          const int kb = kk / spa;
          const uint32_t a_k = (uint32_t)(kb * p.block_m) * x.a_row + (uint32_t)(kk - kb * spa) * 32;
          const uint32_t b_k = (uint32_t)(kk * 16) * x.b_row;
#pragma unroll
          for (int i = 0; i < A; ++i) {
            if (live[i])
              Wgmma<NW>::mma(acc[i], smem_desc(a_s + off_a[i] + a_k, lbo_a, sbo_a, x.a_row),
                             smem_desc(b_s + off_b[i] + b_k, lbo_b, sbo_b, x.b_row));
          }
        }
        wgmma_commit();
        wgmma_wait_one();  // k-step kt - 1's group has retired: its slot is free
#pragma unroll
        for (int i = 0; i < A; ++i)
#pragma unroll
          for (int j = 0; j < NW / 2; ++j) fence_operand(acc[i][j]);
        if (kt > 0 && signal) {
          const uint32_t empty = empty0 + 8 * ((kt - 1) % p.stages);
          mbar_arrive(empty);
          if (p.cluster > 1) mbar_arrive_remote(empty, peer);
        }
      }
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < A; ++i)
#pragma unroll
        for (int j = 0; j < NW / 2; ++j) fence_operand(acc[i][j]);
      if (signal) {
        const uint32_t empty = empty0 + 8 * ((nk - 1) % p.stages);
        mbar_arrive(empty);
        if (p.cluster > 1) mbar_arrive_remote(empty, peer);
      }
    }
    // Every consumer is done with the ring: stage the bf16 tile through it.
    asm volatile("bar.sync 1, %0;\n" ::"r"(consumers) : "memory");
    __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(tma_smem + (ring - raw));
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
    asm volatile("bar.sync 1, %0;\n" ::"r"(consumers) : "memory");
    const int per_row = p.block_n >> 3;
    const int rows_out = min(p.block_m, p.rows - tile_m0);
    for (int c = threadIdx.x; c < rows_out * per_row; c += consumers) {
      const int row = c / per_row, col = (c - row * per_row) * 8;
      const int gc = tile_n0 + col;
      if (gc >= p.N) continue;
      const __nv_bfloat16* src = so + row * ld + col;
      __nv_bfloat16* dst = p.out + (int64_t)(tile_m0 + row) * p.N + gc;
      if (p.vec_out && gc + 8 <= p.N) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
      } else {
        for (int e = 0; e < 8 && gc + e < p.N; ++e) dst[e] = src[e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps and the launch
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver, found through the runtime, so the
// library links against no libcuda.
inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f)
               : nullptr;
  }();
  return fn;
}

// A 2-D bf16 map of a row-major (rows, cols) tensor in boxes of (box_rows,
// box_cols), swizzled by the box's row bytes (none at 16), zero-filled out
// of bounds.
inline int encode_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                      int box_cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (!encode) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const int row_bytes = 2 * box_cols;
  const CUtensorMapSwizzle swizzle = row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                     : row_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                       : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int NW, int A>
int launch_variant(const CUtensorMap& ma, const CUtensorMap& mb, const Args& p, dim3 grid,
                   int threads, int smem, cudaStream_t s) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        tc_gemm_kernel<NW, A>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, tc_gemm_kernel<NW, A>, ma, mb, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

struct Launch {
  const CUtensorMap& ma;
  const CUtensorMap& mb;
  const Args& p;
  dim3 grid;
  int threads, smem;
  cudaStream_t s;
  template <int NW, int A> int run() const {
    return launch_variant<NW, A>(ma, mb, p, grid, threads, smem, s);
  }
};

// Launches the TMA plan (stages, cluster, box_m, smem) of kernels/gemm.py
// `tma_plan` for the warpgroup plan (wm, wn, nw, atoms) of
// `tensor_core_plan`: grid = (cdiv(M, block_m), cdiv(N, block_n)) in
// clusters of (1, cluster, 1).  Operands or a plan that TMA cannot take are
// refused with cudaErrorInvalidValue before anything runs.
inline int launch(const void* a, const void* b, Args p, int nw, int atoms, int smem,
                  cudaStream_t s) {
  const int bm = p.block_m, bn = p.block_n, bk = p.block_k;
  if (const int e = check_plan(bm, bn, bk, p.wm, p.wn, 2, nw, atoms, kSmemMax)) return e;
  const Boxes x(bm, bn, bk);
  const int64_t blocks_x = ((int64_t)p.rows + bm - 1) / bm;
  const int blocks_y = (p.N + bn - 1) / bn;
  if (x.check(bn, bk) || p.K % 8 || p.N % 8 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || p.box_m <= 0 || p.box_m > kBoxMax ||
      p.box_m % 8 || bm % p.box_m || p.cluster < 1 || p.cluster > kMaxCluster ||
      blocks_y % p.cluster || p.stages < 2 || smem < smem_bytes(bm, bn, bk, p.stages) ||
      smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  if (blocks_x > 2147483647LL || blocks_y > 65535) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap ma, mb;
  if (const int e = encode_map(&mb, b, p.K, p.N, x.b_k, x.b_n)) return e;
  if (p.m_live > 0) {
    if (const int e = encode_map(&ma, a, p.m_live, p.K, p.box_m, x.a_k)) return e;
  } else {
    ma = CUtensorMap{};  // no live row: no tile reads A
  }
  return with_variant(nw, atoms, Launch{ma, mb, p, dim3((unsigned)blocks_x, blocks_y),
                                        p.wm * p.wn * kWarpgroup + kProducer, smem, s});
}

}  // namespace tma
}  // namespace tc
}  // namespace
