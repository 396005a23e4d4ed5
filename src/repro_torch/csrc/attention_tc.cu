// Flash attention on Hopper's tensor cores (sm_90a), prefill form, bf16.
//
// Replaces the Pallas TPU kernel `flash_attention` / `_attn_kernel`
// (src/repro/kernels/attention.py) where the selected strategy's backend is
// `tensor_core` and the inputs are bf16.  Same function as csrc/attention.cu:
// online softmax, GQA (kv head = q head // group), shared or per-row
// [kv_len, q_offset], key-validity, causal and window masks at the finite
// -1e30, value rows past kv_len zero, the denominator floored at 1e-30 (a
// kv_len == 0 row is exactly zero), output in bf16.  As in the Pallas kernel,
// the probabilities are rounded to bf16 before the P V product
// (`p.astype(v.dtype)`), and the row sum is taken over the f32 values.
//
// What bounds it on this card: at the served shapes (s <= 256, d = 64) a
// (batch, head) does 4*s*s*d operations on 4*s*d*2 bytes, below the ridge
// of ~295 operations a byte, so bytes bound it; at 96-192 CTAs it is in
// practice latency-bound.  What the design does about it: both products run
// as wgmma on the tensor cores, each K/V byte is read once per CTA round
// through a 2-slot cp.async ring, and the kv loop stops at the CTA's causal
// frontier and kv_len, so only the valid keys are read.
//
// Layout.  One CTA owns one (batch * q head, block_q rows) tile; grid =
// (cdiv(sq, block_q), b * hq).  It has W warpgroups (the host's plan: at
// most 4, fewer for wide heads so the O fragment stays in registers), each
// owning one 64-row atom of a round; a block_q of more than W atoms is
// walked in rounds of W atoms, each streaming its keys again.  Per round:
//
// - Q (W*64 x d) is copied once into shared memory, K-major (attn_tile.cuh);
//   rows past sq are zero and never stored.
// - K and V stream through a 2-slot ring of block_k-key steps: K K-major, V
//   N-major.  Rows at or past kv_len are never read: their shared rows are
//   zero-filled, so the NaN-poisoned tail of an engine staging buffer cannot
//   reach the product.  Slot i is refilled with step i + 2 as soon as every
//   warpgroup has read it.
// - Each step is cut into sub-steps of at most 64 keys.  Per sub-step a
//   warpgroup computes S (64 x 64 f32, 32 floats a thread) as 16-key chunks
//   of wgmma m64n16k16 (K-major B), masks it and updates the online softmax
//   in registers (a row's max and sum reduce over the 4 lanes that share
//   it), packs P to bf16x2 in place as wgmma's A registers, and adds P V
//   into the O fragment (d/2 floats a thread) by wgmma with V as N-major B.
//   A sub-step wholly past the atom's causal frontier, past kv_len or before
//   its window is skipped (warpgroup-uniform: the warpgroup index and the
//   extents are broadcast with __shfl_sync, so ptxas keeps the wgmma
//   pipeline).
//
// Head widths.  d is any multiple of 8 up to 256.  Q K^T contracts over d in
// wgmma's k16 steps, so Q and K sit in shared tiles dp = d rounded up to 16
// wide whose pad columns are zero (they add nothing to Q K^T); P V runs at
// n = d, as n16 products plus one n8 product when d is an odd multiple of
// 8 (h2o-danube3's 120).  The softmax scale is the caller's, from the true
// d.
//
// Shared memory: W*64*dp*2 + 2 * block_k*(dp + d)*2 bytes (= W*64*d*2 +
// 2 * 2*block_k*d*2 when d is a multiple of 16), at most the tile's priced
// footprint AttentionWorkload.l1_tile_bytes (two streamed stages of Q, K and
// V plus the f32 accumulator and scores), so every tile the lattice admits
// launches.  kernels/attention.py `tensor_core_attention_plan` mirrors this
// plan.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kSubKeys = 64;  // keys of one inner sub-step

struct Args {
  const __nv_bfloat16* q;  // (b, hq, sq, d)
  const __nv_bfloat16* k;  // (b, hkv, skv, d)
  const __nv_bfloat16* v;
  __nv_bfloat16* out;      // like q
  const int* info;         // (2, b) [kv_len; q_offset], or null
  int kv_len, q_off;       // shared extents when info is null
  int hq, group, sq, skv;
  int block_q, block_k, warpgroups;
  int causal, window;
  float softcap, scale;
  int vec;  // 16-byte copies allowed (16-byte aligned base pointers)
};

// Most warpgroups a CTA of head width D may have: O (D/2 floats) and S (32
// floats) must fit the registers a thread gets at that block size.
__host__ __device__ constexpr int max_warpgroups(int d) {
  return d <= 64 ? 4 : (d <= 128 ? 2 : 1);
}

// One 16-byte chunk: a cp.async where allowed, else element loads.
__device__ __forceinline__ void copy16(unsigned char* dst, const __nv_bfloat16* src, int vec) {
  if (vec)
    cp_async16(smem_u32(dst), src);
  else
    load8_masked(dst, src, 8);
}

// The shared tiles' width: D rounded up to wgmma's k16.
__host__ __device__ constexpr int padded_d(int d) { return (d + 15) / 16 * 16; }

// Q rows [r0, r0 + rows_cta) into q_s, K-major; rows at or past sq and the
// pad columns past D zero.
template <int D>
__device__ __forceinline__ void load_q(const Args& p, unsigned char* q_s,
                                       const __nv_bfloat16* qh, int r0, int rows_cta) {
  constexpr int DP = padded_d(D);
  for (int c = threadIdx.x; c < rows_cta * (DP / 8); c += blockDim.x) {
    const int grp = c / DP, q = c - grp * DP;  // 8 rows x DP/8 chunks a group
    const int row = r0 + grp * 8 + (q & 7), dc = q >> 3;
    unsigned char* dst = q_s + c * 16;
    if (row < p.sq && dc < D / 8)
      copy16(dst, qh + (int64_t)row * D + dc * 8, p.vec);
    else
      store_zero16(dst);
  }
}

// Keys [kb, kb + block_k) of K (K-major, DP wide, the pad columns zero) and
// V (N-major, D wide) into one slot; keys at or past kv_lim are never read
// and their rows are zeroed.
template <int D>
__device__ __forceinline__ void load_kv(const Args& p, unsigned char* k_s, unsigned char* v_s,
                                        const __nv_bfloat16* kh, const __nv_bfloat16* vh,
                                        int kb, int kv_lim) {
  constexpr int DP = padded_d(D);
  for (int c = threadIdx.x; c < p.block_k * (DP / 8); c += blockDim.x) {
    const int grp = c / DP, q = c - grp * DP;
    const int key = grp * 8 + (q & 7), dc = q >> 3;
    const int gk = kb + key;
    unsigned char* kd = k_s + c * 16;
    if (dc >= D / 8) {  // K's pad column: no V chunk
      store_zero16(kd);
      continue;
    }
    unsigned char* vd = v_s + (dc * p.block_k + key) * 16;
    if (gk < kv_lim) {
      const int64_t off = (int64_t)gk * D + dc * 8;
      copy16(kd, kh + off, p.vec);
      copy16(vd, vh + off, p.vec);
    } else {
      store_zero16(kd);
      store_zero16(vd);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(max_warpgroups(D) * kWarpgroup)
attn_tc_kernel(const Args p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DP = padded_d(D);
  constexpr int kNV = D % 64 == 0 ? 64 : 16;  // width of one P V wgmma
  constexpr int kNTail = D % 16;             // 8: one n8 wgmma after the n16 ones
  const unsigned full = 0xffffffffu;
  const int rows_cta = p.warpgroups * 64;
  unsigned char* q_s = smem;
  unsigned char* ring = smem + rows_cta * DP * 2;
  const int k_bytes = p.block_k * DP * 2, v_bytes = p.block_k * D * 2;
  const int slot_bytes = k_bytes + v_bytes;  // one K and V step

  const int bh = blockIdx.y, bi = bh / p.hq;
  const int kvh = bi * (p.hq / p.group) + (bh % p.hq) / p.group;
  int kv_len = p.kv_len, q_off = p.q_off;
  if (p.info != nullptr) {
    kv_len = p.info[bi];
    q_off = p.info[gridDim.y / p.hq + bi];
  }
  // Broadcast from lane 0: the compiler then knows these are uniform, so the
  // branches on them below keep the wgmma pipeline intact.
  kv_len = __shfl_sync(full, kv_len, 0);
  q_off = __shfl_sync(full, q_off, 0);
  const int wgi = __shfl_sync(full, (int)threadIdx.x / kWarpgroup, 0);
  const int kv_lim = max(0, min(kv_len, p.skv));
  const __nv_bfloat16* qh = p.q + (int64_t)bh * p.sq * D;
  const __nv_bfloat16* kh = p.k + (int64_t)kvh * p.skv * D;
  const __nv_bfloat16* vh = p.v + (int64_t)kvh * p.skv * D;
  __nv_bfloat16* oh = p.out + (int64_t)bh * p.sq * D;

  const int lane = threadIdx.x & 31, warp = (threadIdx.x % kWarpgroup) >> 5;
  const int c2 = 2 * (lane & 3);
  const int sub_keys = min(p.block_k, kSubKeys);
  const int subs = p.block_k / sub_keys;
  const int chunks = sub_keys / 16;  // 16-key chunks of a sub-step
  const uint32_t sbo_k = 16u * DP, sbo_v = 16u * p.block_k;
  const int blk_end = min(p.sq, (int)(blockIdx.x + 1) * p.block_q);

  for (int r0 = blockIdx.x * p.block_q; r0 < blk_end; r0 += rows_cta) {
    const int a0 = r0 + wgi * 64;  // this warpgroup's atom
    const bool live = a0 < blk_end;
    const int rA = a0 + warp * 16 + (lane >> 2), rB = rA + 8;
    const int posA = q_off + rA, posB = q_off + rB;
    // Keys the round needs: up to its last row's causal frontier and kv_len,
    // from its first row's window start.
    int kv_end = kv_lim;
    if (p.causal) kv_end = min(kv_end, q_off + min(r0 + rows_cta, blk_end));
    int kv_begin = p.window > 0 ? max(0, q_off + r0 - p.window + 1) : 0;
    kv_begin = kv_begin / p.block_k * p.block_k;
    const int nblk = kv_end > kv_begin ? (kv_end - kv_begin + p.block_k - 1) / p.block_k : 0;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float mA = kNeg, mB = kNeg, lA = 0.f, lB = 0.f;

    load_q<D>(p, q_s, qh, r0, rows_cta);
    if (nblk > 0) load_kv<D>(p, ring, ring + k_bytes, kh, vh, kv_begin, kv_lim);
    cp_async_commit();
    if (nblk > 1)
      load_kv<D>(p, ring + slot_bytes, ring + slot_bytes + k_bytes, kh, vh,
                 kv_begin + p.block_k, kv_lim);
    cp_async_commit();

    for (int it = 0; it < nblk; ++it) {
      cp_async_wait(1);  // this thread's copies of step `it` landed
      fence_proxy_async();
      __syncthreads();  // everyone's did
      const int kb = kv_begin + it * p.block_k;
      unsigned char* k_s = ring + (it & 1) * slot_bytes;
      unsigned char* v_s = k_s + k_bytes;
      if (live) {
        const uint64_t dq = make_desc(smem_u32(q_s) + wgi * 64 * DP * 2, 128, sbo_k);
        for (int sub = 0; sub < subs; ++sub) {
          const int k0 = kb + sub * sub_keys;
          bool skip = k0 >= kv_lim;
          if (p.causal) skip = skip || k0 > q_off + a0 + 63;
          if (p.window > 0) skip = skip || k0 + sub_keys <= q_off + a0 - p.window + 1;
          if (skip) continue;

          // S = Q K^T: 64 x sub_keys, 16-key chunks of 8 floats.
          float s[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) s[i] = 0.f;
          const uint32_t k_addr = smem_u32(k_s) + sub * sub_keys * DP * 2;
#pragma unroll
          for (int i = 0; i < 32; ++i) fence_operand(s[i]);
          wgmma_fence();
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (t < chunks) {
              const uint64_t dk = make_desc(k_addr + t * 2 * sbo_k, 128, sbo_k);
#pragma unroll
              for (int kk = 0; kk < DP / 16; ++kk)
                wgmma_ss16(s + 8 * t, dq + 16 * kk, dk + 16 * kk);
            }
          }
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int i = 0; i < 32; ++i) fence_operand(s[i]);

          // Masks and the online softmax on the fragment: s[8t + 4j + e] is
          // row (e < 2 ? rA : rB), key k0 + 16t + 8j + c2 + e % 2.
          float cmA = kNeg, cmB = kNeg;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (t < chunks) {
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                const int key = k0 + 16 * t + 8 * (i >> 2) + c2 + (i & 1);
                const int pos = (i & 2) ? posB : posA;
                float x = s[8 * t + i] * p.scale;
                if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
                bool ok = key < kv_lim;
                if (p.causal) ok = ok && key <= pos;
                if (p.window > 0) ok = ok && pos - key < p.window;
                x = ok ? x : kNeg;
                s[8 * t + i] = x;
                if (i & 2)
                  cmB = fmaxf(cmB, x);
                else
                  cmA = fmaxf(cmA, x);
              }
            }
          }
#pragma unroll
          for (int off = 1; off <= 2; off <<= 1) {
            cmA = fmaxf(cmA, __shfl_xor_sync(full, cmA, off));
            cmB = fmaxf(cmB, __shfl_xor_sync(full, cmB, off));
          }
          const float mnA = fmaxf(mA, cmA), mnB = fmaxf(mB, cmB);
          const float alA = __expf(mA - mnA), alB = __expf(mB - mnB);
          mA = mnA;
          mB = mnB;
          lA *= alA;
          lB *= alB;
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? alB : alA;
          uint32_t a[4][4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float pr = t < chunks ? __expf(s[8 * t + i] - ((i & 2) ? mnB : mnA)) : 0.f;
              s[8 * t + i] = pr;
              if (i & 2)
                lB += pr;
              else
                lA += pr;
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) a[t][r] = pack_bf16x2(s[8 * t + 2 * r], s[8 * t + 2 * r + 1]);
          }

          // O += P V: P from registers, V N-major, kNV columns a wgmma.
          const uint32_t v_addr = smem_u32(v_s) + sub * sub_keys * 16;
#pragma unroll
          for (int i = 0; i < D / 2; ++i) fence_operand(o[i]);
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int r = 0; r < 4; ++r) fence_operand(a[t][r]);
          wgmma_fence();
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (t < chunks) {
#pragma unroll
              for (int cc = 0; cc < D / kNV; ++cc) {
                const uint64_t dv = make_desc(
                    v_addr + t * 256 + cc * (kNV / 8) * sbo_v, 128, sbo_v);
                WgmmaRS<kNV>::mma(o + cc * (kNV / 2), a[t], dv);
              }
              if (kNTail) {  // the last 8 columns
                const uint64_t dv = make_desc(v_addr + t * 256 + (D / 8 - 1) * sbo_v, 128, sbo_v);
                WgmmaRS<8>::mma(o + (D - 8) / 2, a[t], dv);
              }
            }
          }
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int i = 0; i < D / 2; ++i) fence_operand(o[i]);
        }
      }
      __syncthreads();  // every warpgroup is done reading slot it % 2
      if (it + 2 < nblk) {
        unsigned char* st = ring + (it & 1) * slot_bytes;
        load_kv<D>(p, st, st + k_bytes, kh, vh, kb + 2 * p.block_k, kv_lim);
      }
      cp_async_commit();
    }
    cp_async_wait(0);

    if (live) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        lA += __shfl_xor_sync(full, lA, off);
        lB += __shfl_xor_sync(full, lB, off);
      }
      const float invA = 1.f / fmaxf(lA, 1e-30f), invB = 1.f / fmaxf(lB, 1e-30f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + c2;
        if (rA < blk_end)
          *reinterpret_cast<__nv_bfloat162*>(oh + (int64_t)rA * D + col) =
              __floats2bfloat162_rn(o[4 * j] * invA, o[4 * j + 1] * invA);
        if (rB < blk_end)
          *reinterpret_cast<__nv_bfloat162*>(oh + (int64_t)rB * D + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * invB, o[4 * j + 3] * invB);
      }
    }
    __syncthreads();  // the next round rewrites Q and the ring
  }
}

template <int D>
int launch_d(const Args& p, dim3 grid, int threads, int smem, cudaStream_t s) {
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  attn_tc_kernel<D><<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, hq, sq, d), k/v (b, hkv, skv, d), out like q, all contiguous bf16.
// `info` is null (kv_len/q_offset serve every row) or a device int32 (2, b)
// array [kv_len; q_offset].  window <= 0 and softcap <= 0 mean "none".
// `warpgroups` and `smem` are the host's plan; a plan that does not describe
// the tile is refused with cudaErrorInvalidValue before anything runs.
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* out,
                                         const int* info, int kv_len, int q_offset, int b, int hq,
                                         int hkv, int sq, int skv, int d, int block_q, int block_k,
                                         int warpgroups, int smem, int causal, int window,
                                         float softcap, float scale, void* stream) {
  if (b <= 0 || hq <= 0 || sq <= 0) return (int)cudaGetLastError();
  if (hkv <= 0 || hq % hkv || d % 8 || d <= 0 || d > 256 || block_q % 64 || block_k % 16 ||
      block_q <= 0 || block_k <= 0 || warpgroups < 1 || warpgroups > max_warpgroups(d) ||
      warpgroups > block_q / 64)
    return (int)cudaErrorInvalidValue;
  const int64_t need = 2LL * (64LL * warpgroups * padded_d(d) + 2LL * block_k * (padded_d(d) + d));
  if (smem != need || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if ((int64_t)b * hq > 65535) return (int)cudaErrorInvalidConfiguration;
  Args p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.info = info;
  p.kv_len = kv_len;
  p.q_off = q_offset;
  p.hq = hq;
  p.group = hq / hkv;
  p.sq = sq;
  p.skv = skv;
  p.block_q = block_q;
  p.block_k = block_k;
  p.warpgroups = warpgroups;
  p.causal = causal;
  p.window = window;
  p.softcap = softcap;
  p.scale = scale;
  p.vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
            reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const dim3 grid((sq + block_q - 1) / block_q, b * hq);
  const int threads = warpgroups * kWarpgroup;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d / 8) {
    case 1: return launch_d<8>(p, grid, threads, smem, s);
    case 2: return launch_d<16>(p, grid, threads, smem, s);
    case 3: return launch_d<24>(p, grid, threads, smem, s);
    case 4: return launch_d<32>(p, grid, threads, smem, s);
    case 5: return launch_d<40>(p, grid, threads, smem, s);
    case 6: return launch_d<48>(p, grid, threads, smem, s);
    case 7: return launch_d<56>(p, grid, threads, smem, s);
    case 8: return launch_d<64>(p, grid, threads, smem, s);
    case 9: return launch_d<72>(p, grid, threads, smem, s);
    case 10: return launch_d<80>(p, grid, threads, smem, s);
    case 11: return launch_d<88>(p, grid, threads, smem, s);
    case 12: return launch_d<96>(p, grid, threads, smem, s);
    case 13: return launch_d<104>(p, grid, threads, smem, s);
    case 14: return launch_d<112>(p, grid, threads, smem, s);
    case 15: return launch_d<120>(p, grid, threads, smem, s);
    case 16: return launch_d<128>(p, grid, threads, smem, s);
    case 17: return launch_d<136>(p, grid, threads, smem, s);
    case 18: return launch_d<144>(p, grid, threads, smem, s);
    case 19: return launch_d<152>(p, grid, threads, smem, s);
    case 20: return launch_d<160>(p, grid, threads, smem, s);
    case 21: return launch_d<168>(p, grid, threads, smem, s);
    case 22: return launch_d<176>(p, grid, threads, smem, s);
    case 23: return launch_d<184>(p, grid, threads, smem, s);
    case 24: return launch_d<192>(p, grid, threads, smem, s);
    case 25: return launch_d<200>(p, grid, threads, smem, s);
    case 26: return launch_d<208>(p, grid, threads, smem, s);
    case 27: return launch_d<216>(p, grid, threads, smem, s);
    case 28: return launch_d<224>(p, grid, threads, smem, s);
    case 29: return launch_d<232>(p, grid, threads, smem, s);
    case 30: return launch_d<240>(p, grid, threads, smem, s);
    case 31: return launch_d<248>(p, grid, threads, smem, s);
    case 32: return launch_d<256>(p, grid, threads, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
