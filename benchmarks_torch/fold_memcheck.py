"""Out-of-bounds check of the engine's folded launches on the card.

An unaligned engine call on the card launches the bucket's kernel on the
caller's operands at their true extents (core/engine.py
``_launch_folds``), so every kernel path must stop reading and writing at
the operand's own last row.  This script makes chip_smoke.py phase 3c's
folded calls once at small widths -- the GEMM at both backends in bf16
and float32, the grouped GEMM at both backends, prefill attention at both
backends, decode with a per-row and with one kv_len, conv2d -- each one
row off its bucket, each held bit for bit against ``call_padded``.

By default it checks with guards of its own: each dynamic operand is
followed in its allocation by 4096 NaN elements, so a read past its last
row reaches the output (which must be finite and equal the zero-padded
call's), and each output the kernel wrappers allocate is followed by a
canary, which must be unchanged after every launch.  With ``--sanitizer``
it drops the guards, so that under the memory checker, with PyTorch's
caching allocator off, each operand is an allocation of its own and a
read or write one row past it is an error the checker reports:

    python benchmarks_torch/fold_memcheck.py
    python -c 'import sys; sys.path.insert(0, "src"); \\
        from repro_torch.kernels.build import library; library()'
    PYTORCH_NO_CUDA_MEMORY_CACHING=1 compute-sanitizer --tool memcheck \\
        --error-exitcode 1 python benchmarks_torch/fold_memcheck.py \\
        --sanitizer

(the second line builds the kernels outside the checker).  It exits 1
without a CUDA device, and on any guard that moved.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

TAIL = 4096  # guard elements after each operand and each output
CANARY = 1234.0  # exact in bf16 and float32


class GuardedOutputs:
    """Stands in for ``torch`` inside the kernel wrappers' modules: every
    tensor they allocate with ``empty``/``empty_like`` is the head of a
    buffer whose last ``TAIL`` elements hold ``CANARY``."""

    def __init__(self):
        self.tails: list[torch.Tensor] = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def _guarded(self, shape, dtype, device) -> torch.Tensor:
        n = 1
        for d in shape:
            n *= int(d)
        buf = torch.empty(n + TAIL, dtype=dtype, device=device)
        buf[n:] = CANARY
        self.tails.append(buf[n:])
        return buf[:n].view(tuple(shape))

    def empty(self, *size, dtype=None, device=None, **kw):
        if len(size) == 1 and not isinstance(size[0], int):
            size = tuple(size[0])
        return self._guarded(size, dtype or torch.get_default_dtype(),
                             device)

    def empty_like(self, t, **kw):
        return self._guarded(t.shape, kw.get("dtype") or t.dtype,
                             kw.get("device") or t.device)

    def moved(self) -> int:
        """Canary elements a launch overwrote."""
        return sum(int((t != CANARY).sum()) for t in self.tails)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sanitizer", action="store_true",
                    help="no guards: each operand its own allocation")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("fold_memcheck: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch import kernels
    from repro_torch.kernels import attention, gemm, grouped_gemm

    guard = None
    if not args.sanitizer:
        guard = GuardedOutputs()
        for mod in (gemm, grouped_gemm, attention):
            mod.torch = guard
    folded = chip_smoke.phase_fold(torch.device("cuda"), kernels, small=True,
                                   tail=0 if args.sanitizer else TAIL)
    torch.cuda.synchronize()
    card = chip_smoke.card_name()
    if guard is None:
        print(f"fold_memcheck: {len(folded)} folded launches ran, no guards "
              f"(the memory checker's run) on {card}")
        return 0
    moved = guard.moved()
    print(f"fold_memcheck: {len(folded)} folded launches, every read past "
          f"an operand's last row would have read NaN; {len(guard.tails)} "
          f"guarded outputs, {moved} canary elements overwritten on {card}")
    return 1 if moved else 0


if __name__ == "__main__":
    sys.exit(main())
