// The dispatch engine's staging copy for Hopper (sm_90a): every unaligned
// operand of one engine call copied into the leading corner of its
// bucket-shaped staging buffer, in ONE launch.
//
// Replaces the reference's `_stage_into` (src/repro/core/engine.py, one
// jitted, donated in-place `dynamic_update_slice` per operand, run before
// the AOT program of the bucket); it is not a Pallas kernel.  What it
// computes is the same: only the true extent of each buffer is written,
// the pad tail keeps its stale bytes (the masked-tail kernels never read
// them).
//
// Each operand is a table entry: a contiguous source of `planes` planes of
// `plane_bytes` bytes, copied to planes `dst_pitch` bytes apart in the
// buffer (one dynamic dim; the dims inside it are whole, so each plane is
// contiguous on both sides).  blockIdx.y picks the entry; the blocks of
// grid.x stride over its 16-byte words (bytes when a size or pointer is
// not 16-byte aligned).
//
// What bounds it on this card: the bytes (each source byte read once and
// written once, at 3.35 TB/s), at a few µs; the launch it saves against
// one copy per operand is host time, which sets the unaligned engine
// call's cost (ROADMAP C4).
#include <cuda_runtime.h>
#include <stdint.h>

// The launch table (kernels/stage.py mirrors it with ctypes).  Outside the
// anonymous namespace: the exported launcher takes it.
struct VortexStageOp {
  const uint8_t* src;
  uint8_t* dst;
  long long planes;
  long long plane_bytes;
  long long dst_pitch;
};

constexpr int kStageMaxOps = 4;

struct VortexStageTable {
  VortexStageOp op[kStageMaxOps];
  int n;
};

namespace {

constexpr int kThreads = 256;

using StageOp = VortexStageOp;
using StageTable = VortexStageTable;

__global__ void __launch_bounds__(kThreads) stage_copy_kernel(StageTable t) {
  const StageOp o = t.op[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool vec = ((o.plane_bytes | o.dst_pitch |
                     (long long)(uintptr_t)o.src |
                     (long long)(uintptr_t)o.dst) & 15) == 0;
  if (vec) {
    const long long per = o.plane_bytes >> 4;
    const long long total = o.planes * per;
    const uint4* src = reinterpret_cast<const uint4*>(o.src);
    for (long long i = first; i < total; i += stride) {
      const long long p = i / per;
      uint4* dst = reinterpret_cast<uint4*>(o.dst + p * o.dst_pitch);
      dst[i - p * per] = src[i];
    }
  } else {
    const long long total = o.planes * o.plane_bytes;
    for (long long i = first; i < total; i += stride) {
      const long long p = i / o.plane_bytes;
      o.dst[p * o.dst_pitch + (i - p * o.plane_bytes)] = o.src[i];
    }
  }
}

}  // namespace

// Launches the staging copy of `table->n` (1..4) operands on `stream`;
// returns the cudaError_t of the launch (0 on success).
extern "C" int vortex_stage_launch(const VortexStageTable* table,
                                   void* stream) {
  if (table->n < 1 || table->n > kStageMaxOps) return (int)cudaErrorInvalidValue;
  long long most = 0;
  for (int i = 0; i < table->n; ++i) {
    const VortexStageOp& o = table->op[i];
    const long long words = (o.planes * o.plane_bytes + 15) / 16;
    most = words > most ? words : most;
  }
  if (most == 0) return (int)cudaGetLastError();
  long long blocks = (most + kThreads - 1) / kThreads;
  blocks = blocks < 1056 ? blocks : 1056;  // 8 a streaming multiprocessor
  stage_copy_kernel<<<dim3((unsigned)blocks, (unsigned)table->n), kThreads, 0,
                      (cudaStream_t)stream>>>(*table);
  return (int)cudaGetLastError();
}
