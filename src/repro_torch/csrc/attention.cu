// Masked-tail flash attention for Hopper (sm_90a) on the CUDA cores: the
// prefill path of a `cuda_core` strategy, and of float32 at either backend
// (Hopper has no exact f32 tensor-core product).  bf16 prefill at a
// `tensor_core` strategy runs csrc/attention_tc.cu, and the decode form
// csrc/attention_decode.cu; kernels/attention.py fixes the path.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_attn_kernel`
// (src/repro/kernels/attention.py).  It computes the same function:
// softmax(q k^T d^-1/2, optional tanh softcap) v with an online softmax,
// GQA (kv head = q head // group), per-row or shared [kv_len, q_offset]
// extents, key validity k_pos < kv_len, causal k_pos <= q_offset + q_pos,
// window q_pos - k_pos < window.  Masked scores take the FINITE value
// -1e30 (never -inf), value rows past kv_len read as zero, and the
// denominator is floored at 1e-30, so a kv_len == 0 row is exactly zero.
// It also computes the decode form (sq == 1, block_q == 1), which the
// wrapper sends to csrc/attention_decode.cu instead.
//
// Translation, not transliteration: the TPU kernel's sequential kv grid
// axis becomes a loop inside the block, its VMEM scratch (m, l, acc)
// becomes registers, and each block reads its own kv_len/q_offset.
//
// What bounds it on this card: prefill at the served shapes (s <= 256,
// d = 64) does 4*s*s*d FLOPs over 4*s*d*2 bytes per head, far below the
// 295 FLOP/byte ridge, so the bound is device-memory bytes; decode reads
// the whole K/V cache for one query row and is bytes-bound by
// construction.  What the design does about it: every K/V element is read
// once per q sub-block through shared memory, blocks stop at the row's
// kv_len (and at the causal frontier), so the bytes touched are what the
// valid extent needs, not the bucket.  The FMAs run on the CUDA cores in
// f32.
//
// Thread layout: 128 threads per block.  The q block is walked in
// sub-blocks of QS = min(block_q, 16) rows; each row is owned by a group
// of TPR lanes inside one warp (TPR = 8, 16 or 32), which hold the row's
// running max/sum redundantly and split its head_dim accumulator.
// Shared memory: Q (QS x d), K and V (KS x d each, KS = min(block_k, 64))
// and the probabilities (QS x KS), all f32.  With QS <= block_q and
// KS <= block_k this never exceeds AttentionWorkload.l1_tile_bytes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxQS = 16;
constexpr int kMaxKS = 64;
constexpr int kMaxAcc = 32;   // head_dim <= kMaxAcc * TPR (TPR >= 8 -> d <= 256)
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__host__ __device__ __forceinline__ int sub_rows(int block_q) {
  return block_q < kMaxQS ? block_q : kMaxQS;
}
__host__ __device__ __forceinline__ int sub_keys(int block_k) {
  return block_k < kMaxKS ? block_k : kMaxKS;
}
__host__ __device__ __forceinline__ int lanes_per_row(int qs) {
  return qs > 8 ? 8 : (qs > 4 ? 16 : 32);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            T* __restrict__ out, const int* __restrict__ info, int kv_len_all,
            int q_off_all, int hq, int group, int sq, int skv, int d, int block_q,
            int block_k, int causal, int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const int QS = sub_rows(block_q);
  const int KS = sub_keys(block_k);
  const int TPR = lanes_per_row(QS);
  float* Qs = smem;              // [QS][d]
  float* Ks = Qs + QS * d;       // [KS][d]
  float* Vs = Ks + KS * d;       // [KS][d]
  float* Ps = Vs + KS * d;       // [QS][KS]

  const int bh = blockIdx.y;                 // flattened (batch, q head)
  const int kvh = (bh / hq) * (hq / group) + (bh % hq) / group;
  int kv_len = kv_len_all, q_off = q_off_all;
  if (info != nullptr) {                     // per-batch-row extents, (2, b)
    const int rows = gridDim.y / hq;
    kv_len = info[bh / hq];
    q_off = info[rows + bh / hq];
  }
  const int kv_lim = min(kv_len, skv);       // keys at/past this are masked
  const T* qh = q + (int64_t)bh * sq * d;
  const T* kh = k + (int64_t)kvh * skv * d;
  const T* vh = v + (int64_t)kvh * skv * d;
  T* oh = out + (int64_t)bh * sq * d;

  const int tid = threadIdx.x;
  const int g = tid / TPR;                   // row group
  const int lane = tid % TPR;
  const unsigned full = 0xffffffffu;

  const int q_blk0 = blockIdx.x * block_q;
  for (int qs0 = 0; qs0 < block_q; qs0 += QS) {
    const int row0 = q_blk0 + qs0;           // first q row of this sub-block
    if (row0 >= sq) break;                   // block-uniform
    const int nrows = min(QS, min(block_q - qs0, sq - row0));
    const bool gvalid = g < nrows;
    const int qi = row0 + (gvalid ? g : 0);
    const int q_pos = q_off + qi;

    for (int e = tid; e < QS * d; e += kThreads) {
      const int r = e / d, c = e % d;
      Qs[e] = r < nrows ? to_f32(qh[(int64_t)(row0 + r) * d + c]) : 0.f;
    }
    // Keys past the causal frontier of the sub-block's last row, or past
    // kv_len, are masked for every row: the loop stops there.
    int kv_end = kv_lim;
    if (causal) kv_end = min(kv_end, q_off + row0 + nrows);
    float m = kNeg, l = 0.f;
    float acc[kMaxAcc];
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
    __syncthreads();

    for (int kv0 = 0; kv0 < kv_end; kv0 += KS) {
      for (int e = tid; e < KS * d; e += kThreads) {
        const int t = e / d, c = e % d;
        const int key = kv0 + t;
        const bool ok = key < kv_lim;        // predicated: masked rows never read
        Ks[e] = ok ? to_f32(kh[(int64_t)key * d + c]) : 0.f;
        Vs[e] = ok ? to_f32(vh[(int64_t)key * d + c]) : 0.f;
      }
      __syncthreads();

      float cmax = kNeg;
      if (gvalid) {
        for (int t = lane; t < KS; t += TPR) {
          const int key = kv0 + t;
          float s = 0.f;
          const float* kr = Ks + t * d;
          const float* qr = Qs + g * d;
          int c = lane % d;                  // rotate start: spreads banks
          for (int i = 0; i < d; ++i) {
            s = fmaf(qr[c], kr[c], s);
            c = (c + 1 == d) ? 0 : c + 1;
          }
          s *= scale;
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          bool valid = key < kv_lim;
          if (causal) valid = valid && key <= q_pos;
          if (window > 0) valid = valid && (q_pos - key < window);
          s = valid ? s : kNeg;
          Ps[g * KS + t] = s;
          cmax = fmaxf(cmax, s);
        }
      }
      for (int off = TPR / 2; off > 0; off >>= 1)
        cmax = fmaxf(cmax, __shfl_xor_sync(full, cmax, off, TPR));
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
      if (gvalid) {
        for (int t = lane; t < KS; t += TPR) {
          const float p = expf(Ps[g * KS + t] - m_new);
          Ps[g * KS + t] = p;
          psum += p;
        }
      }
      for (int off = TPR / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(full, psum, off, TPR);
      l = l * alpha + psum;
      m = m_new;
      __syncwarp();
      if (gvalid) {
#pragma unroll
        for (int j = 0; j < kMaxAcc; ++j) {
          const int c = lane + TPR * j;
          if (c < d) {
            float a = acc[j] * alpha;
            for (int t = 0; t < KS; ++t) a = fmaf(Ps[g * KS + t], Vs[t * d + c], a);
            acc[j] = a;
          }
        }
      }
      __syncthreads();
    }

    if (gvalid) {
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int j = 0; j < kMaxAcc; ++j) {
        const int c = lane + TPR * j;
        if (c < d) oh[(int64_t)qi * d + c] = from_f32<T>(acc[j] * inv);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, const int* info,
           int kv_len, int q_off, int b, int hq, int hkv, int sq, int skv, int d,
           int block_q, int block_k, int causal, int window, float softcap,
           float scale, cudaStream_t stream) {
  const int QS = sub_rows(block_q), KS = sub_keys(block_k);
  const size_t smem = (size_t)(QS * d + 2 * KS * d + QS * KS) * sizeof(float);
  auto kern = attn_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((sq + block_q - 1) / block_q, b * hq);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), info, kv_len, q_off, hq, hq / hkv, sq, skv, d, block_q,
      block_k, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, hq, sq, d), k/v (b, hkv, skv, d), out like q, all contiguous and of
// one dtype (0 = float32, 1 = bfloat16).  `info` is null (the scalar
// kv_len/q_offset serve every row) or a device int32 (2, b) array
// [kv_len; q_offset].  window <= 0 and softcap <= 0 mean "none".
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* out, const int* info, int kv_len,
                                      int q_offset, int b, int hq, int hkv, int sq,
                                      int skv, int d, int block_q, int block_k,
                                      int causal, int window, float softcap,
                                      float scale, int dtype, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, info, kv_len, q_offset, b, hq, hkv, sq, skv, d,
                         block_q, block_k, causal, window, softcap, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, info, kv_len, q_offset, b, hq, hkv, sq,
                                 skv, d, block_q, block_k, causal, window, softcap,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}
