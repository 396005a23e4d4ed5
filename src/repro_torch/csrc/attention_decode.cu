// Flash attention on Hopper (sm_90a), decode form: split-kv with the GQA
// group folded into the CTA.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_attn_kernel`
// (src/repro/kernels/attention.py) at sq == 1, block_q == 1: one query row
// per (batch row, q head) against a kv-bucketed cache.  Same function as
// csrc/attention.cu: GQA (kv head = q head // group), shared or per-row
// [kv_len, q_offset], key-validity, causal and window masks, an optional
// tanh softcap, value rows past kv_len never read, the denominator floored
// at 1e-30 (a kv_len == 0 row is exactly zero), output in q's dtype.  Keys
// outside a row's valid range [window start, min(kv_len, causal frontier))
// get exactly 0 weight: they are never visited.
//
// What bounds it on this card: one query row reads the whole valid cache,
// 4*d operations per 4*d bytes of K and V (bf16), far below the ridge of
// ~295 operations a byte, so device-memory bytes bound it; at the served
// sizes (a few hundred KB) launch and latency do.  What the design does
// about it:
//
// - One CTA per (batch row, kv head, kv split) computes all `group` query
//   heads of that kv head, so K and V are read once per kv head, not once
//   per q head.  The host picks the number of splits so that the grid
//   covers the card's SMs (from kv_len when it is one number, from the
//   bucket otherwise); a split is a whole number of block_k-key blocks, and
//   one that starts past a row's range does no work.
// - 128 threads; a key row is read by LPK lanes (the least power of two with
//   8*LPK >= d), each with one 16-byte load of bf16 (two of f32), so a warp
//   reads 32/LPK consecutive rows.  Each lane group keeps its own online
//   softmax (m, l, acc) over the keys it visits, for up to GB query heads
//   (longer groups are walked in batches of GB, re-reading K/V from L2).
// - The lane groups' partials merge by the log-sum-exp rule, in the warp by
//   shuffles and across warps through shared memory.  With one split the
//   CTA writes the output.  With more, each CTA writes its (m, l, acc) to a
//   workspace, and the last CTA of each (batch row, kv head) to finish --
//   an atomic ticket taken after a __threadfence -- merges them in the same
//   launch and resets its ticket to 0 for the next launch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr float kNeg = -1e30f;

template <typename T> struct DArgs {
  const T* q;         // (b, hq, 1, d)
  const T* k;         // (b, hkv, skv, d)
  const T* v;
  T* out;             // (b, hq, 1, d)
  const int* info;    // (2, b) [kv_len; q_offset], or null
  float* part;        // (b * hkv, nsplit, group, d + 2) when nsplit > 1
  int* tickets;       // (b * hkv,) zero before the launch, zero after it
  int kv_len, q_off;  // shared extents when info is null
  int hq, hkv, skv, d;
  int causal, window;
  float softcap, scale;
  int split_keys, nsplit, lpk, vec;
};

// 8 elements [e0, e0 + 8) of a row as f32; those at or past d read as 0.
__device__ __forceinline__ void load8(float* dst, const __nv_bfloat16* row, int e0, int d,
                                      bool vec) {
  if (vec && e0 + 8 <= d) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + e0);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      dst[2 * i] = f.x;
      dst[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = e0 + i < d ? __bfloat162float(row[e0 + i]) : 0.f;
  }
}

__device__ __forceinline__ void load8(float* dst, const float* row, int e0, int d, bool vec) {
  if (vec && e0 + 8 <= d) {
    const float4 a = *reinterpret_cast<const float4*>(row + e0);
    const float4 b = *reinterpret_cast<const float4*>(row + e0 + 4);
    dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
    dst[4] = b.x; dst[5] = b.y; dst[6] = b.z; dst[7] = b.w;
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = e0 + i < d ? row[e0 + i] : 0.f;
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Merges the partial (m2, l2, a2) into (m, l, a) by the log-sum-exp rule.
__device__ __forceinline__ float lse_scale(float m, float m2, float* s1, float* s2) {
  const float mn = fmaxf(m, m2);
  *s1 = __expf(m - mn);
  *s2 = __expf(m2 - mn);
  return mn;
}

template <typename T, int GB>
__global__ void __launch_bounds__(kThreads) attn_decode_kernel(const DArgs<T> p) {
  __shared__ float sm_acc[kWarps][GB][kMaxD];
  __shared__ float sm_m[kWarps][GB], sm_l[kWarps][GB];
  __shared__ int sm_last;
  const unsigned full = 0xffffffffu;
  const int bkv = blockIdx.y, bi = bkv / p.hkv, h = bkv % p.hkv;
  const int split = blockIdx.x;
  const int group = p.hq / p.hkv, d = p.d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lpk = p.lpk, gl = lane / lpk, li = lane % lpk;
  const int kpw = 32 / lpk;  // keys a warp reads at once
  const int e0 = li * 8;     // this lane's 8 elements of a row

  int kv_len = p.kv_len, q_off = p.q_off;
  if (p.info != nullptr) {
    kv_len = p.info[bi];
    q_off = p.info[gridDim.y / p.hkv + bi];
  }
  // The row's valid keys [lo, hi); this split's share of them.
  int hi = min(kv_len, p.skv);
  if (p.causal) hi = min(hi, q_off + 1);
  const int lo = p.window > 0 ? max(0, q_off - p.window + 1) : 0;
  const int k_start = max(lo, split * p.split_keys);
  const int k_stop = min(hi, (split + 1) * p.split_keys);

  const T* kh = p.k + (int64_t)bkv * p.skv * d;
  const T* vh = p.v + (int64_t)bkv * p.skv * d;
  const bool vec = p.vec;

  for (int g0 = 0; g0 < group; g0 += GB) {
    const int gn = min(GB, group - g0);
    const int64_t qrow0 = ((int64_t)bi * p.hq + (int64_t)h * group + g0) * d;
    float qv[GB][8], acc[GB][8], m[GB], l[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < gn) {
        load8(qv[g], p.q + qrow0 + (int64_t)g * d, e0, d, vec);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qv[g][e] = 0.f;
      }
      m[g] = kNeg;
      l[g] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
    }
    // Warp-uniform trip count: every lane takes part in the shuffles.
    for (int base = k_start + warp * kpw; base < k_stop; base += kWarps * kpw) {
      const int key = base + gl;
      const bool ok = key < k_stop;
      float kv[8], vv[8];
      if (ok) {
        load8(kv, kh + (int64_t)key * d, e0, d, vec);
        load8(vv, vh + (int64_t)key * d, e0, d, vec);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < gn) {
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) s = fmaf(qv[g][e], kv[e], s);
          for (int off = 1; off < lpk; off <<= 1) s += __shfl_xor_sync(full, s, off);
          if (ok) {
            s *= p.scale;
            if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
            const float mn = fmaxf(m[g], s);
            const float al = __expf(m[g] - mn), pr = __expf(s - mn);
            m[g] = mn;
            l[g] = l[g] * al + pr;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, vv[e], acc[g][e] * al);
          }
        }
      }
    }
    // Merge the lane groups of the warp, then the warps.
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < gn) {
        for (int off = lpk; off < 32; off <<= 1) {
          const float m2 = __shfl_xor_sync(full, m[g], off);
          const float l2 = __shfl_xor_sync(full, l[g], off);
          float s1, s2;
          m[g] = lse_scale(m[g], m2, &s1, &s2);
          l[g] = l[g] * s1 + l2 * s2;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float a2 = __shfl_xor_sync(full, acc[g][e], off);
            acc[g][e] = acc[g][e] * s1 + a2 * s2;
          }
        }
        if (gl == 0) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (e0 + e < d) sm_acc[warp][g][e0 + e] = acc[g][e];
          if (li == 0) {
            sm_m[warp][g] = m[g];
            sm_l[warp][g] = l[g];
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < gn * d; i += kThreads) {
      const int g = i / d, e = i - g * d;
      float mm = kNeg;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][g]);
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float sc = __expf(sm_m[w][g] - mm);
        ll += sm_l[w][g] * sc;
        aa += sm_acc[w][g][e] * sc;
      }
      if (p.nsplit == 1) {
        store(p.out + qrow0 + (int64_t)g * d + e, aa / fmaxf(ll, 1e-30f));
      } else {
        float* pp = p.part + (((int64_t)bkv * p.nsplit + split) * group + g0 + g) * (d + 2);
        pp[e] = aa;
        if (e == 0) {
          pp[d] = mm;
          pp[d + 1] = ll;
        }
      }
    }
    __syncthreads();  // the next head batch reuses the shared partials
  }
  if (p.nsplit == 1) return;

  // The last CTA of this (batch row, kv head) merges every split.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sm_last = atomicAdd(p.tickets + bkv, 1) == p.nsplit - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  const int64_t out0 = ((int64_t)bi * p.hq + (int64_t)h * group) * d;
  for (int i = threadIdx.x; i < group * d; i += kThreads) {
    const int g = i / d, e = i - g * d;
    const float* pp = p.part + ((int64_t)bkv * p.nsplit * group + g) * (d + 2);
    const int64_t step = (int64_t)group * (d + 2);
    float mm = kNeg;
    for (int s = 0; s < p.nsplit; ++s) mm = fmaxf(mm, __ldcg(pp + s * step + d));
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < p.nsplit; ++s) {
      const float sc = __expf(__ldcg(pp + s * step + d) - mm);
      ll += __ldcg(pp + s * step + d + 1) * sc;
      aa += __ldcg(pp + s * step + e) * sc;
    }
    store(p.out + out0 + (int64_t)g * d + e, aa / fmaxf(ll, 1e-30f));
  }
  if (threadIdx.x == 0) p.tickets[bkv] = 0;  // ready for the next launch
}

template <typename T>
int launch(DArgs<T> p, int b, cudaStream_t s) {
  const int group = p.hq / p.hkv;
  const dim3 grid(p.nsplit, b * p.hkv);
  if (group >= 8) {
    attn_decode_kernel<T, 8><<<grid, kThreads, 0, s>>>(p);
  } else if (group >= 4) {
    attn_decode_kernel<T, 4><<<grid, kThreads, 0, s>>>(p);
  } else if (group >= 2) {
    attn_decode_kernel<T, 2><<<grid, kThreads, 0, s>>>(p);
  } else {
    attn_decode_kernel<T, 1><<<grid, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out, const int* info,
                 float* part, int* tickets, int kv_len, int q_off, int b, int hq, int hkv,
                 int skv, int d, int causal, int window, float softcap, float scale,
                 int split_keys, int nsplit, cudaStream_t s) {
  DArgs<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.out = static_cast<T*>(out);
  p.info = info;
  p.part = part;
  p.tickets = tickets;
  p.kv_len = kv_len;
  p.q_off = q_off;
  p.hq = hq;
  p.hkv = hkv;
  p.skv = skv;
  p.d = d;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  p.split_keys = split_keys;
  p.nsplit = nsplit;
  p.lpk = 1;
  while (8 * p.lpk < d) p.lpk *= 2;
  p.vec = (d * (int)sizeof(T)) % 16 == 0 &&
          ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
            reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  return launch<T>(p, b, s);
}

}  // namespace

// q (b, hq, 1, d), k/v (b, hkv, skv, d), out like q, all contiguous and of one
// dtype (0 = float32, 1 = bfloat16).  `info` is null (kv_len/q_offset serve
// every row) or a device int32 (2, b) array [kv_len; q_offset].  The grid is
// (nsplit, b * hkv), each split covering split_keys keys.  With nsplit > 1,
// `part` holds b*hkv*nsplit*(hq/hkv)*(d+2) floats of scratch and `tickets`
// b*hkv int32 that are zero before the launch (the launch leaves them zero).
extern "C" int flash_decode_launch(const void* q, const void* k, const void* v, void* out,
                                   const int* info, void* part, void* tickets, int kv_len,
                                   int q_offset, int b, int hq, int hkv, int skv, int d,
                                   int causal, int window, float softcap, float scale,
                                   int split_keys, int nsplit, int dtype, void* stream) {
  if (b <= 0 || hq <= 0) return (int)cudaGetLastError();
  if (hkv <= 0 || hq % hkv || d <= 0 || d > kMaxD || nsplit < 1 || split_keys < 1 ||
      (nsplit > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if ((int64_t)b * hkv > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  if (dtype == 0)
    return launch_typed<float>(q, k, v, out, info, pf, tk, kv_len, q_offset, b, hq, hkv, skv, d,
                               causal, window, softcap, scale, split_keys, nsplit, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, out, info, pf, tk, kv_len, q_offset, b, hq, hkv,
                                       skv, d, causal, window, softcap, scale, split_keys, nsplit,
                                       s);
  return (int)cudaErrorInvalidValue;
}
