// Ragged grouped GEMM for Hopper (sm_90a): out[g] = x[g] @ w[g / r].
//
// Replaces the Pallas TPU kernel `vortex_grouped_gemm` /
// `_grouped_gemm_kernel` (src/repro/kernels/grouped_gemm.py).  What it
// computes is the same: G capacity-shaped (C, K) activation slabs, each
// against expert g / r of the stacked (E, K, N) weights (r = G / E, groups
// expert-major), f32 accumulation cast to the output type.  Each group's
// true row count is read from the device vector `counts` INSIDE the kernel
// (routing produces it on the card; the host never waits for it).  Rows
// at or past counts[g] are never read (the pad may hold NaN) and their
// output rows are WRITTEN as exact zeros, so a torch.empty output leaks
// nothing.  K/N tails are masked, the selected layer-1 tile (block_m,
// block_n, block_k) is the launch geometry, and one launch covers every
// group.
//
// What bounds it on this card: at the served shapes (granite-moe: K = 1024,
// N = 512 or the reverse) prefill is bound by the bytes of the expert
// weights and the output, and decode by reading the expert weights: a
// decode makes each batch row its own routing group, so r = batch and
// C = 1, and an expert's live rows are scattered over its r one-row
// groups.  Two paths, chosen by the wrapper from the selected strategy's
// backend and the dtype before the launch:
//
// - tensor_core (bf16): vortex_grouped_gemm_tc_launch, tc::grouped_gemm_kernel,
//   the wgmma tile on a cp.async ring (the wrappers of csrc/wgmma.cuh).
//   The stacked decomposition: the r groups of an expert are adjacent, so
//   x (G, C, K) is the (E, r * C, K) tensor and out (G, C, N) the
//   (E, r * C, N) one, and an m-tile walks an expert's stacked rows:
//   grid = (E * cdiv(r * C, block_m), cdiv(N, block_n)).  Stacked row i of
//   expert e is row i % C of group e * r + i / C and is live iff that row
//   is below the group's count; a tile never reaches past its expert's
//   r * C rows.  So each weight strip is read once for all of an expert's
//   groups instead of once per group (r times: 32 in granite's 32-row
//   decode), and a decode launches r times fewer CTAs.  A launch stacks
//   where that takes fewer m-tiles than one group a tile (r > 1 and
//   C % block_m != 0, unless the remainder of C is most of a tile); else
//   its tiles are one group's, grid = (G * cdiv(C, block_m), ...), as with
//   r = 1 (a prefill's one group).  Dead rows are never read: a slot's
//   first fill zeroes them and they stay zero, and a refill copies the
//   live rows alone (a stacked tile first lists its live rows in shared
//   memory past the ring; a tile of one group has a prefix of live rows
//   and needs no list); a 64-row atom with no live row issues no wgmma,
//   and a tile with none only stores zeros.  Each output row is the same
//   f32 sum, in the same order, as in a launch of its group alone.
// - cuda_core (a cuda_core strategy, or float32 at either backend):
//   vortex_grouped_gemm_launch, csrc/gemm.cu's FMA loop plus a group
//   index: shared-memory staged operand slices and 4x4 register
//   micro-tiles; a 64-row sub-tile that starts at or past counts[g] skips
//   the k loop and only stores zeros.  Its m-tiles stay one group's, so
//   every group of an expert re-reads that expert's weight tile (from L2).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int kThreads = 256;   // fixed block size (16 x 16 threads)
constexpr int kSub = 64;        // register-tiled sub-tile edge (16 threads x 4)
constexpr int kChunk = 16;      // k depth staged per shared-memory round

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ counts, T* __restrict__ out, int C, int N,
                    int K, int r, int gm, int block_m, int block_n, int block_k) {
  extern __shared__ float smem[];
  const int sub_m = min(block_m, kSub);
  const int sub_n = min(block_n, kSub);
  const int kc = min(block_k, kChunk);
  float* As = smem;                 // [kc][sub_m]
  float* Bs = smem + kc * sub_m;    // [kc][sub_n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int g = blockIdx.x / gm;
  const int tile_m0 = (blockIdx.x - g * gm) * block_m;
  const int tile_n0 = blockIdx.y * block_n;
  const T* xg = x + (int64_t)g * C * K;
  const T* wg = w + (int64_t)(g / r) * K * N;
  T* og = out + (int64_t)g * C * N;
  const int row_lim = max(0, min(C, counts[g]));  // rows at/past this read as zero

  for (int sm0 = 0; sm0 < block_m; sm0 += sub_m) {
    for (int sn0 = 0; sn0 < block_n; sn0 += sub_n) {
      const int r0 = tile_m0 + sm0, c0 = tile_n0 + sn0;
      if (r0 >= C || c0 >= N) continue;  // block-uniform: whole sub-tile out of bounds
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      // Block-uniform: a sub-tile wholly past the group's count stores zeros.
      if (r0 < row_lim) {
        for (int k0 = 0; k0 < K; k0 += block_k) {
          for (int kk0 = k0; kk0 < k0 + block_k && kk0 < K; kk0 += kc) {
            for (int e = tid; e < kc * sub_m; e += kThreads) {
              const int kk = e / sub_m, rr = e % sub_m;
              const int gr = r0 + rr, gk = kk0 + kk;
              float v = 0.f;
              if (gr < row_lim && gk < K && gk < k0 + block_k) v = to_f32(xg[(int64_t)gr * K + gk]);
              As[kk * sub_m + rr] = v;
            }
            for (int e = tid; e < kc * sub_n; e += kThreads) {
              const int kk = e / sub_n, cc = e % sub_n;
              const int gc = c0 + cc, gk = kk0 + kk;
              float v = 0.f;
              if (gc < N && gk < K && gk < k0 + block_k) v = to_f32(wg[(int64_t)gk * N + gc]);
              Bs[kk * sub_n + cc] = v;
            }
            __syncthreads();
            for (int kk = 0; kk < kc; ++kk) {
              float av[4], bv[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int rr = ty + 16 * i;
                av[i] = rr < sub_m ? As[kk * sub_m + rr] : 0.f;
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int cc = tx + 16 * j;
                bv[j] = cc < sub_n ? Bs[kk * sub_n + cc] : 0.f;
              }
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
            __syncthreads();
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = ty + 16 * i;
        const int gr = r0 + rr;
        if (rr >= sub_m || gr >= C) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = tx + 16 * j;
          const int gc = c0 + cc;
          // Rows past the count: exactly zero (masked A rows give +0 sums,
          // and a skipped sub-tile keeps its zero accumulator).
          if (cc < sub_n && gc < N) og[(int64_t)gr * N + gc] = from_f32<T>(acc[i][j]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const int* counts, void* out, int G, int E, int C,
           int N, int K, int block_m, int block_n, int block_k, cudaStream_t stream) {
  const int sub_m = block_m < kSub ? block_m : kSub;
  const int sub_n = block_n < kSub ? block_n : kSub;
  const int kc = block_k < kChunk ? block_k : kChunk;
  const size_t smem = (size_t)kc * (sub_m + sub_n) * sizeof(float);
  const int gm = (C + block_m - 1) / block_m;
  const int64_t blocks_x = (int64_t)G * gm;
  const int blocks_y = (N + block_n - 1) / block_n;
  if (blocks_x > 2147483647LL || blocks_y > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)blocks_x, blocks_y);
  grouped_gemm_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), counts, static_cast<T*>(out), C, N,
      K, G / E, gm, block_m, block_n, block_k);
  return (int)cudaGetLastError();
}

}  // namespace

namespace {
namespace tc {

// The launch's operands.  A slab is the rows an m-tile walks: an expert's r
// groups stacked (slab_groups = r) when that takes fewer m-tiles than one
// group a slab (slab_groups = 1: a tile lies in one group, whose live rows
// are a prefix of it).  The groups of an expert are adjacent, so slab b of
// rows_slab = slab_groups * C rows starts at row b * rows_slab of x and of
// out, and multiplies expert b * slab_groups / r.
struct GroupedArgs {
  const __nv_bfloat16* x;  // (G, C, K) row-major
  const __nv_bfloat16* w;  // (E, K, N) row-major
  const int* counts;       // (G,) live rows per group
  __nv_bfloat16* out;      // (G, C, N)
  int C, r, slab_groups, rows_slab, gm, N, K;
  int block_m, block_n, block_k;
  int wm, wn, stages;
  int ring_bytes;  // the plan's shared memory: the ring, then the epilogue's tile
  int stacked;     // slab_groups > 1
  int vec_x, vec_w, vec_out;  // 16-byte copies allowed (aligned rows)
};

// Shared memory a stacked launch adds past the ring: a bit a tile row (live
// or not) and the list of the live rows, ascending.
inline int stacked_extra_bytes(int block_m) { return block_m / 8 + 2 * block_m; }

// Copies one 16-byte chunk of x (row `row` of the slab, from column gk)
// into shared memory at dst, or zeroes it: a dead row, or the K tail.
__device__ __forceinline__ void copy_x_chunk(const GroupedArgs& p, unsigned char* dst,
                                             const __nv_bfloat16* xb, int row, int gk,
                                             bool live) {
  if (live && gk < p.K) {
    const __nv_bfloat16* src = xb + (int64_t)row * p.K + gk;
    if (p.vec_x && gk + 8 <= p.K)
      cp_async16(smem_u32(dst), src);
    else
      load8_masked(dst, src, min(8, p.K - gk));
  } else {
    store_zero16(dst);
  }
}

// Fills one ring slot with k-step k0 / block_k: the tile's live rows, and
// the whole B tile.  A slot's first fill walks the first a_rows rows in
// csrc/tc_tile.cuh's chunk order and zeroes the dead ones (unset in
// live_bits when the launch is stacked, past the prefix of n_live rows
// otherwise), which stay zero; a refill copies the n_live live rows alone
// (live_rows[li], or row li of the prefix).
__device__ __forceinline__ void load_grouped_stage(const GroupedArgs& p,
                                                   const uint32_t* live_bits,
                                                   const uint16_t* live_rows, int n_live,
                                                   int a_rows, unsigned char* a_s,
                                                   unsigned char* b_s, const __nv_bfloat16* xb,
                                                   const __nv_bfloat16* wb, int tile_m0,
                                                   int tile_n0, int k0, bool first_fill) {
  const int kc = p.block_k >> 3;
  const int per_group = 8 * kc;  // chunks per 8-row (A) or 8-column (B) group
  const bool pow2 = (per_group & (per_group - 1)) == 0;
  const int shift = __ffs(per_group) - 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  if (first_fill) {
    for (int c = tid; c < a_rows * kc; c += nt) {
      const int grp = pow2 ? c >> shift : c / per_group;
      const int q = c - grp * per_group;
      const int i = grp * 8 + (q & 7);  // the row in the tile
      const bool live = p.stacked ? (live_bits[i >> 5] >> (i & 31)) & 1u : i < n_live;
      copy_x_chunk(p, a_s + c * 16, xb, tile_m0 + i, k0 + (q >> 3) * 8, live);
    }
  } else {
    // Live row li in the place of row li of csrc/tc_tile.cuh's order: a
    // prefix of n_live rows is copied as there.
    for (int c = tid; c < ((n_live + 7) & ~7) * kc; c += nt) {
      const int grp = pow2 ? c >> shift : c / per_group;
      const int q = c - grp * per_group;
      const int li = grp * 8 + (q & 7);
      if (li < n_live) {
        const int i = p.stacked ? live_rows[li] : li;
        copy_x_chunk(p, a_s + ((i >> 3) * per_group + (q & ~7) + (i & 7)) * 16, xb,
                     tile_m0 + i, k0 + (q >> 3) * 8, true);
      }
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
      const __nv_bfloat16* src = wb + (int64_t)gk * p.N + gn;
      if (p.vec_w && gn + 8 <= p.N)
        cp_async16(smem_u32(dst), src);
      else
        load8_masked(dst, src, min(8, p.N - gn));
    } else {
      store_zero16(dst);
    }
  }
}

// One CTA: the (block_m, block_n) tile at row tile_m0 of slab b.  The math,
// ring and epilogue are csrc/tc_tile.cuh's; what differs is which rows are
// live and that the tile ends at the slab's rows_slab.
template <int NW, int A>
__global__ void __launch_bounds__(kMaxThreads) grouped_gemm_kernel(const GroupedArgs p) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  uint32_t* live_bits = reinterpret_cast<uint32_t*>(tc_smem + p.ring_bytes);
  uint16_t* live_rows = reinterpret_cast<uint16_t*>(live_bits + p.block_m / 32);
  const int b = blockIdx.x / p.gm;
  const int tile_m0 = (blockIdx.x - b * p.gm) * p.block_m;
  const int tile_n0 = blockIdx.y * p.block_n;
  const __nv_bfloat16* xb = p.x + (int64_t)b * p.rows_slab * p.K;
  const __nv_bfloat16* wb = p.w + (int64_t)(b * p.slab_groups / p.r) * p.K * p.N;
  __nv_bfloat16* ob = p.out + (int64_t)b * p.rows_slab * p.N;
  const int* cb = p.counts + (int64_t)b * p.slab_groups;
  const int tile_rows = min(p.block_m, p.rows_slab - tile_m0);  // the rest is the next slab's

  // n_live live rows, one past the last of them (hi), and a bit for each
  // 64-row atom that holds one.
  int n_live = 0, hi = 0;
  uint32_t atom_bits = 0;
  if (p.stacked) {
    // Slab row s = tile_m0 + i is row s % C of the slab's group s / C.  Every
    // warp walks the whole mask (so every thread ends with the same counts)
    // and writes the words assigned to it.
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    for (int wd = 0; wd < p.block_m / 32; ++wd) {
      const int i = wd * 32 + lane;
      bool live = false;
      if (i < tile_rows) {
        const int s = tile_m0 + i, grp = s / p.C;
        live = s - grp * p.C < cb[grp];
      }
      const uint32_t bits = __ballot_sync(0xffffffffu, live);
      if (wd % nwarps == warp) {
        if (lane == 0) live_bits[wd] = bits;
        if (live) live_rows[n_live + __popc(bits & ((1u << lane) - 1u))] = (uint16_t)i;
      }
      if (bits) {
        hi = wd * 32 + 32 - __clz(bits);
        atom_bits |= 1u << (wd >> 1);
      }
      n_live += __popc(bits);
    }
    __syncthreads();
  } else {
    n_live = hi = max(0, min(tile_rows, min(p.C, cb[0]) - tile_m0));
    const int atoms = (hi + 63) >> 6;  // at most 32: check_plan's 2048 rows
    atom_bits = atoms >= 32 ? ~0u : (1u << atoms) - 1u;
  }
  // Broadcast from lane 0, as each warpgroup's index: the compiler then
  // knows they are uniform, so the branches on them below keep the wgmma
  // pipeline intact.
  n_live = __shfl_sync(0xffffffffu, n_live, 0);
  hi = __shfl_sync(0xffffffffu, hi, 0);
  atom_bits = __shfl_sync(0xffffffffu, atom_bits, 0);
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / kWarpgroup, 0);
  const int rows_wg = p.block_m / p.wm, cols_wg = p.block_n / p.wn;
  const int atoms_n = cols_wg / NW;
  const int wg_r0 = (wgi % p.wm) * rows_wg, wg_c0 = (wgi / p.wm) * cols_wg;

  float acc[A][NW / 2];
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc[i][j] = 0.f;

  // Block-uniform: a tile with no live row skips the k loop.
  if (hi > 0) {
    const int a_rows = min(p.block_m, (hi + 63) & ~63);
    const int a_bytes = p.block_m * p.block_k * 2;
    const int stage_bytes = a_bytes + p.block_k * p.block_n * 2;
    const int nk = (p.K + p.block_k - 1) / p.block_k;
    const uint32_t lbo = 128, sbo = 16u * p.block_k;
    bool live[A];
    uint32_t off_a[A], off_b[A];
#pragma unroll
    for (int i = 0; i < A; ++i) {
      const int r0 = wg_r0 + (i / atoms_n) * 64, c0 = wg_c0 + (i % atoms_n) * NW;
      live[i] = (atom_bits >> (r0 >> 6)) & 1u;  // warpgroup-uniform
      off_a[i] = (uint32_t)r0 * p.block_k * 2;
      off_b[i] = (uint32_t)c0 * p.block_k * 2;
    }
    for (int s = 0; s < p.stages; ++s) {
      if (s < nk) {
        unsigned char* st = tc_smem + s * stage_bytes;
        load_grouped_stage(p, live_bits, live_rows, n_live, a_rows, st, st + a_bytes, xb, wb,
                           tile_m0, tile_n0, s * p.block_k, true);
      }
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait(p.stages - 1);  // this thread's copies of k-step kt landed
      fence_proxy_async();
      __syncthreads();  // everyone's copies of k-step kt landed
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
        load_grouped_stage(p, live_bits, live_rows, n_live, a_rows, st, st + a_bytes, xb, wb,
                           tile_m0, tile_n0, nxt * p.block_k, false);
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
  // Rows past a group's count are exact zeros (zero A rows, or an atom's
  // untouched accumulator); rows past the slab's are not written.
  const int per_row = p.block_n >> 3;
  for (int c = threadIdx.x; c < tile_rows * per_row; c += blockDim.x) {
    const int row = c / per_row, col = (c - row * per_row) * 8;
    const int gc = tile_n0 + col;
    if (gc >= p.N) continue;
    const __nv_bfloat16* src = so + row * ld + col;
    __nv_bfloat16* dst = ob + (int64_t)(tile_m0 + row) * p.N + gc;
    if (p.vec_out && gc + 8 <= p.N) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && gc + e < p.N; ++e) dst[e] = src[e];
    }
  }
}

struct GroupedLaunch {
  const GroupedArgs& p;
  dim3 grid;
  int threads, smem;
  cudaStream_t s;
  template <int NW, int A> int run() const {
    static bool configured = false;  // one attribute call per instantiation
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(
          grouped_gemm_kernel<NW, A>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    grouped_gemm_kernel<NW, A><<<grid, threads, smem, s>>>(p);
    return (int)cudaGetLastError();
  }
};

}  // namespace tc
}  // namespace

// The CUDA-core path.  dtype: 0 = float32, 1 = bfloat16 (x, w and out share
// it); counts is a device int32 (G,) vector.  G must be a multiple of E.
extern "C" int vortex_grouped_gemm_launch(const void* x, const void* w, const void* counts,
                                          void* out, int G, int E, int C, int N, int K,
                                          int block_m, int block_n, int block_k, int dtype,
                                          void* stream) {
  if (G <= 0 || C <= 0 || N <= 0) return (int)cudaGetLastError();
  if (E <= 0 || G % E != 0 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(counts);
  if (dtype == 0)
    return launch<float>(x, w, c, out, G, E, C, N, K, block_m, block_n, block_k, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, w, c, out, G, E, C, N, K, block_m, block_n, block_k, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core path (bf16): the tile plan (wm, wn, nw, atoms, stages,
// smem_bytes) comes from kernels/gemm.py `tensor_core_plan`; the grid is
// kernels/grouped_gemm.py `stacked_grid`'s.
extern "C" int vortex_grouped_gemm_tc_launch(const void* x, const void* w, const void* counts,
                                             void* out, int G, int E, int C, int N, int K,
                                             int block_m, int block_n, int block_k, int wm,
                                             int wn, int nw, int atoms, int stages,
                                             int smem_bytes, void* stream) {
  if (G <= 0 || C <= 0 || N <= 0) return (int)cudaGetLastError();
  if (E <= 0 || G % E != 0 || K < 0 || block_m <= 0) return (int)cudaErrorInvalidValue;
  if (const int e = tc::check_plan(block_m, block_n, block_k, wm, wn, stages, nw, atoms,
                                   smem_bytes))
    return e;
  tc::GroupedArgs p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.counts = static_cast<const int*>(counts);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.C = C;
  p.r = G / E;
  // Stack an expert's groups where that takes fewer m-tiles than one group
  // a tile, which needs r > 1 and C % block_m != 0.
  const int64_t per_group = (C + block_m - 1) / block_m;
  const int64_t per_expert = ((int64_t)p.r * C + block_m - 1) / block_m;
  p.stacked = per_expert < p.r * per_group;
  p.slab_groups = p.stacked ? p.r : 1;
  if ((int64_t)p.slab_groups * C > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  p.rows_slab = p.slab_groups * C;
  p.gm = (int)(p.stacked ? per_expert : per_group);
  p.N = N;
  p.K = K;
  p.block_m = block_m;
  p.block_n = block_n;
  p.block_k = block_k;
  p.wm = wm;
  p.wn = wn;
  p.stages = stages;
  p.ring_bytes = smem_bytes;
  const int smem = smem_bytes + (p.stacked ? tc::stacked_extra_bytes(block_m) : 0);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  p.vec_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_w = N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  p.vec_out = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t blocks_x = (int64_t)(G / p.slab_groups) * p.gm;
  const int blocks_y = (N + block_n - 1) / block_n;
  if (blocks_x > 2147483647LL || blocks_y > 65535) return (int)cudaErrorInvalidConfiguration;
  return tc::with_variant(
      nw, atoms,
      tc::GroupedLaunch{p, dim3((unsigned)blocks_x, blocks_y), wm * wn * kWarpgroup, smem,
                        static_cast<cudaStream_t>(stream)});
}
