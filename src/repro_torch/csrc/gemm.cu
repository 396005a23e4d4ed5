// Vortex-tiled masked-tail GEMM for Hopper (sm_90a): C[M,N] = A[M,K] @ B[K,N].
//
// Replaces the Pallas TPU kernel `vortex_gemm` / `_gemm_kernel`
// (src/repro/kernels/gemm.py).  What it computes is the same: f32
// accumulation cast to the output type, rows at or past the runtime
// `m_true` read as zero (the pad tail of a staged bucket buffer may hold
// NaN), static K/N tails masked, out-of-bounds stores dropped, and the
// selected layer-1 tile (block_m, block_n, block_k) honoured verbatim as
// the launch geometry, the k reduction walked in block_k steps inside the
// block.
//
// What bounds it on this card: at the shapes the engine serves (M up to a
// few thousand, N = K = 768; conv2d's im2col at M = 25,088) the product
// is bound by the bytes it moves or by the tensor cores (989 TFLOP/s bf16).
// Two paths, one per backend of the H100 lattice, chosen by the wrapper
// from the selected strategy's backend and the dtype before the launch:
//
// - tensor_core (bf16): vortex_gemm_tma_launch, the wgmma tile fed by a
//   TMA producer warp through an mbarrier ring in swizzled shared memory,
//   A multicast across a 2-CTA cluster along N at tall tiles
//   (csrc/tc_tma.cuh); operands TMA cannot address take
//   vortex_gemm_tc_launch, the wgmma tile on a cp.async ring
//   (csrc/tc_tile.cuh).  Both: grid = (cdiv(M, block_m), cdiv(N, block_n)).
// - cuda_core (a cuda_core strategy, or float32 at either backend: Hopper
//   has no exact f32 tensor-core product): vortex_gemm_launch, f32 FMAs on
//   the CUDA cores.  Each block stages (sub_m x kc) and (kc x sub_n)
//   operand slices in shared memory and every thread keeps a 4x4 register
//   micro-tile, so each operand element loaded from device memory is
//   reused 64 times; grid = (cdiv(N, block_n), cdiv(M, block_m)).  Shared
//   memory (kc*sub_m + kc*sub_n)*4 bytes with sub_m <= block_m,
//   sub_n <= block_n, kc <= block_k never exceeds the lattice's
//   l1_tile_bytes for the tile, so every tile the lattice admits launches.
//   Masked lanes are never read: every load is predicated and yields 0.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tc_tile.cuh"
#include "tc_tma.cuh"

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
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
            int M, int N, int K, int m_true, int block_m, int block_n, int block_k) {
  extern __shared__ float smem[];
  const int sub_m = min(block_m, kSub);
  const int sub_n = min(block_n, kSub);
  const int kc = min(block_k, kChunk);
  float* As = smem;                 // [kc][sub_m]
  float* Bs = smem + kc * sub_m;    // [kc][sub_n]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row_lim = min(M, m_true);  // rows at/past this read as zero
  const int tile_m0 = blockIdx.y * block_m;
  const int tile_n0 = blockIdx.x * block_n;

  for (int sm0 = 0; sm0 < block_m; sm0 += sub_m) {
    for (int sn0 = 0; sn0 < block_n; sn0 += sub_n) {
      const int r0 = tile_m0 + sm0, c0 = tile_n0 + sn0;
      if (r0 >= M || c0 >= N) continue;  // block-uniform: whole sub-tile out of bounds
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

      // Temporal reduction over k: block_k steps, each staged in kc slices.
      for (int k0 = 0; k0 < K; k0 += block_k) {
        for (int kk0 = k0; kk0 < k0 + block_k && kk0 < K; kk0 += kc) {
          for (int e = tid; e < kc * sub_m; e += kThreads) {
            const int kk = e / sub_m, r = e % sub_m;
            const int gr = r0 + r, gk = kk0 + kk;
            float v = 0.f;
            if (gr < row_lim && gk < K && gk < k0 + block_k) v = to_f32(a[(int64_t)gr * K + gk]);
            As[kk * sub_m + r] = v;
          }
          for (int e = tid; e < kc * sub_n; e += kThreads) {
            const int kk = e / sub_n, c = e % sub_n;
            const int gc = c0 + c, gk = kk0 + kk;
            float v = 0.f;
            if (gc < N && gk < K && gk < k0 + block_k) v = to_f32(b[(int64_t)gk * N + gc]);
            Bs[kk * sub_n + c] = v;
          }
          __syncthreads();
          for (int kk = 0; kk < kc; ++kk) {
            float av[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = ty + 16 * i;
              av[i] = r < sub_m ? As[kk * sub_m + r] : 0.f;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = tx + 16 * j;
              bv[j] = c < sub_n ? Bs[kk * sub_n + c] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
          __syncthreads();
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int gr = r0 + r;
        if (r >= sub_m || gr >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int gc = c0 + c;
          if (c < sub_n && gc < N) out[(int64_t)gr * N + gc] = from_f32<T>(acc[i][j]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* out, int M, int N, int K, int m_true,
           int block_m, int block_n, int block_k, cudaStream_t stream) {
  const int sub_m = block_m < kSub ? block_m : kSub;
  const int sub_n = block_n < kSub ? block_n : kSub;
  const int kc = block_k < kChunk ? block_k : kChunk;
  const size_t smem = (size_t)kc * (sub_m + sub_n) * sizeof(float);
  dim3 grid((N + block_n - 1) / block_n, (M + block_m - 1) / block_m);
  gemm_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      M, N, K, m_true, block_m, block_n, block_k);
  return (int)cudaGetLastError();
}

}  // namespace

// The CUDA-core path.  dtype: 0 = float32, 1 = bfloat16 (A, B and C share it).
extern "C" int vortex_gemm_launch(const void* a, const void* b, void* out, int M, int N,
                                  int K, int m_true, int block_m, int block_n,
                                  int block_k, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, out, M, N, K, m_true, block_m, block_n, block_k, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, out, M, N, K, m_true, block_m, block_n, block_k, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core path's cp.async kernel (bf16), for operands TMA cannot
// address: the tile plan (wm, wn, nw, atoms, stages, smem_bytes) comes from
// kernels/gemm.py `tensor_core_plan`.
extern "C" int vortex_gemm_tc_launch(const void* a, const void* b, void* out, int M, int N,
                                     int K, int m_true, int block_m, int block_n, int block_k,
                                     int wm, int wn, int nw, int atoms, int stages,
                                     int smem_bytes, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  if (block_m <= 0) return (int)cudaErrorInvalidValue;
  tc::Args p{};
  p.x = static_cast<const __nv_bfloat16*>(a);
  p.w = static_cast<const __nv_bfloat16*>(b);
  p.counts = nullptr;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.rows = M;
  p.N = N;
  p.K = K;
  p.m_true = m_true;
  p.r = 1;
  p.gm = (M + block_m - 1) / block_m;
  p.block_m = block_m;
  p.block_n = block_n;
  p.block_k = block_k;
  p.wm = wm;
  p.wn = wn;
  p.stages = stages;
  p.vec_x = K % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  p.vec_w = N % 8 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  p.vec_out = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return tc::launch(p, 1, nw, atoms, smem_bytes, static_cast<cudaStream_t>(stream));
}

// The tensor-core path's TMA kernel (bf16): the warpgroup plan (wm, wn, nw,
// atoms) comes from kernels/gemm.py `tensor_core_plan`, the ring (stages,
// cluster, box_m, smem_bytes) from `tma_plan`.  m_live is the live row
// count (rows of A at or past it are never read).
extern "C" int vortex_gemm_tma_launch(const void* a, const void* b, void* out, int M, int N,
                                      int K, int m_live, int block_m, int block_n, int block_k,
                                      int wm, int wn, int nw, int atoms, int stages, int cluster,
                                      int box_m, int smem_bytes, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaGetLastError();
  if (block_m <= 0 || block_n <= 0 || block_k <= 0) return (int)cudaErrorInvalidValue;
  tc::tma::Args p{};
  p.out = static_cast<__nv_bfloat16*>(out);
  p.rows = M;
  p.N = N;
  p.K = K;
  p.m_live = m_live < 0 ? 0 : (m_live < M ? m_live : M);
  p.block_m = block_m;
  p.block_n = block_n;
  p.block_k = block_k;
  p.wm = wm;
  p.wn = wn;
  p.stages = stages;
  p.cluster = cluster;
  p.box_m = box_m;
  p.vec_out = N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  return tc::tma::launch(a, b, p, nw, atoms, smem_bytes, static_cast<cudaStream_t>(stream));
}
