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
// group: grid = (G * cdiv(C, block_m), cdiv(N, block_n)), the flattened
// (group, m-tile) index on x, whose limit is 2^31 - 1 (y stops at 65535).
// An expert's r groups are adjacent on x, so its weight tiles come from L2.
//
// What bounds it on this card: at the served shapes (granite-moe: K = 1024,
// N = 512 or the reverse) prefill is bound by the bytes of the expert
// weights and the output, and decode (one real row per expert slab) by
// reading the expert weights.  Two paths, chosen by the wrapper from the
// selected strategy's backend and the dtype before the launch:
//
// - tensor_core (bf16): vortex_grouped_gemm_tc_launch, the wgmma tile on a
//   cp.async ring in csrc/tc_tile.cuh.  Rows past the count are never read
//   and their shared-memory rows are zeroed once, a 64-row atom past the
//   count issues no wgmma, and a tile past it only stores zeros: in decode
//   a CTA reads one row of x and its weight tile.
// - cuda_core (a cuda_core strategy, or float32 at either backend):
//   vortex_grouped_gemm_launch, csrc/gemm.cu's FMA loop plus a group
//   index: shared-memory staged operand slices and 4x4 register
//   micro-tiles; a 64-row sub-tile that starts at or past counts[g] skips
//   the k loop and only stores zeros.
//
// Like the TPU grid, every group of an expert re-reads that expert's
// weight tile (r reads per expert, from L2); sharing them in shared memory
// is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_tile.cuh"

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
// smem_bytes) comes from kernels/gemm.py `tensor_core_plan`.
extern "C" int vortex_grouped_gemm_tc_launch(const void* x, const void* w, const void* counts,
                                             void* out, int G, int E, int C, int N, int K,
                                             int block_m, int block_n, int block_k, int wm,
                                             int wn, int nw, int atoms, int stages,
                                             int smem_bytes, void* stream) {
  if (G <= 0 || C <= 0 || N <= 0) return (int)cudaGetLastError();
  if (E <= 0 || G % E != 0 || K < 0 || block_m <= 0) return (int)cudaErrorInvalidValue;
  tc::Args p{};
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.counts = static_cast<const int*>(counts);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.rows = C;
  p.N = N;
  p.K = K;
  p.m_true = C;
  p.r = G / E;
  p.gm = (C + block_m - 1) / block_m;
  p.block_m = block_m;
  p.block_n = block_n;
  p.block_k = block_k;
  p.wm = wm;
  p.wn = wn;
  p.stages = stages;
  p.vec_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_w = N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  p.vec_out = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return tc::launch(p, G, nw, atoms, smem_bytes, static_cast<cudaStream_t>(stream));
}
