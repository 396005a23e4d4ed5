"""Paper Fig. 13 on the port — model-level dynamic-shape performance.

End-to-end prefill latency of the GPT-2-class smoke model across dynamic
sequence lengths, Vortex-bucketed serving (``VortexServer`` on the host
mesh: seq buckets from the engine, one prefill program per bucket; on the
card each is one captured CUDA graph) against the exact-shape workflow
(``models.model.prefill_step`` at every distinct shape, under the same
rules).  The reference's exact-shape stand-in compiles one XLA executable
per shape; eager PyTorch compiles nothing, so here the exact-shape side
pays only its eager execution.  Reported: the bucketed stream's mean
microseconds per request and the ratio of the two streams' totals.

    python benchmarks_torch/bench_models.py [--device cpu]
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmarks_torch.util import bench_args, emit  # noqa: E402
from repro_torch.core.timing import synchronize  # noqa: E402
from repro_torch.launch import mesh as meshes  # noqa: E402
from repro_torch.launch.serve import Request, VortexServer  # noqa: E402
from repro_torch.models.model import prefill_step  # noqa: E402
from repro_torch.models.registry import get_smoke_config  # noqa: E402

SEQ_LENS = [5, 17, 33, 52, 61, 77, 90, 101, 115, 120]  # "17 seq lens" style


def main() -> None:
    device = bench_args().device
    cfg = get_smoke_config("paper-gpt2-124m")
    mesh = meshes.make_host_mesh(device=device)
    try:
        server = VortexServer(cfg, mesh=mesh, max_cache=128, device=device)
        rng = np.random.default_rng(0)

        # --- Vortex-bucketed stream -----------------------------------
        t0 = time.perf_counter()
        for s in SEQ_LENS:
            toks = rng.integers(0, cfg.vocab, (2, s)).astype(np.int64)
            server.generate(Request(tokens=toks, max_new=1))
        vortex_total = time.perf_counter() - t0

        # --- exact-shape workflow: the prefill at every distinct shape --
        t0 = time.perf_counter()
        with torch.no_grad(), server.engine.use():
            for s in SEQ_LENS:
                toks = torch.from_numpy(
                    rng.integers(0, cfg.vocab, (2, s)).astype(np.int64)
                ).to(server.device)
                logits, _, _ = prefill_step(
                    cfg, server.params, toks, cache_len=128, last=s - 1,
                    rules=server.rules)
                synchronize(logits)
        exact_total = time.perf_counter() - t0
    finally:
        meshes.destroy()

    emit(
        "models/gpt2_dynamic_stream",
        vortex_total / len(SEQ_LENS) * 1e6,
        f"speedup_vs_exact_shape={exact_total / vortex_total:.2f};"
        f"buckets_vortex={server.stats['prefill_buckets']};"
        f"shapes_exact={len(SEQ_LENS)};device={server.device}",
    )


if __name__ == "__main__":
    main()
