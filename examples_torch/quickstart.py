"""Quickstart: the Vortex sample-free workflow through the port's public API
(the PyTorch counterpart of examples/quickstart.py).

    PYTHONPATH=src python examples_torch/quickstart.py               # on the GPU
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu  # plain versions

Walks the paper's pipeline end to end on the H100 lattice:
  1. offline  -- hardware-aware candidate lattice (no shape samples),
  2. offline  -- the hybrid analyzer scores it into a selection table,
  3. runtime  -- per-shape strategy selection and bucketed execution,
and prints candidate counts, offline seconds, selection overhead and each
result's error against its plain PyTorch version.  On the card the
dispatches launch the hand-written kernels; with ``--device cpu`` they run
the kernels' plain versions.
"""
import argparse
import time

import torch

from repro_torch import vortex
from repro_torch.core.candidates import generate_lattice
from repro_torch.core.hardware import H100_SXM
from repro_torch.core.workloads import AttentionWorkload, GemmWorkload
from repro_torch.kernels.ref import ref_attention, ref_conv2d, ref_gemm
from repro_torch.vortex import Engine, EngineConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)

    # The BERT GEMM of the paper's section 2.2: M dynamic, N/K fixed.
    wl = GemmWorkload(M=None, N=768, K=2304)

    print("== offline: strategy space hierarchization (H100 target) ==")
    for backend in H100_SXM.backends:
        lat = generate_lattice(H100_SXM, wl, backend)
        print(f" {backend:11s}: {len(lat.l0)} level-0 x {len(lat.l1)} "
              f"level-1 tiles, {lat.num_candidates()} candidates")
    alat = generate_lattice(
        H100_SXM, AttentionWorkload(seq=None, head_dim=64), "tensor_core"
    )
    print(f" attention (seq-dynamic) lattice: {alat.num_candidates()} "
          "candidates through the same Algorithm 2")

    print(f"\n== offline: an engine session on {dev} ==")
    t0 = time.perf_counter()
    eng = Engine(EngineConfig(hardware="h100_sxm", device=args.device))
    gemm = vortex.compile(wl, engine=eng)
    table = gemm.kernel.selector.table  # materialize the table offline
    print(f" offline stage: {time.perf_counter() - t0:.2f}s "
          f"({len(table)}-entry selection table, impl={eng.config.impl})")

    print("\n== runtime: dynamic GEMM shapes, sample-free ==")
    g = torch.Generator().manual_seed(0)
    dt = torch.bfloat16 if dev.type == "cuda" else torch.float32
    b = torch.randn(wl.K, wl.N, generator=g).to(dev, dt)
    with vortex.use(eng):
        for m in (5, 62, 128, 200, 381):
            a = torch.randn(m, wl.K, generator=g).to(dev, dt)
            t_sel = time.perf_counter()
            sel = gemm.select(m)
            sel_us = (time.perf_counter() - t_sel) * 1e6
            out = vortex.ops.gemm(a, b)
            err = (out.float() - ref_gemm(a, b).float()).abs().max().item()
            print(f" M={m:4d} -> bucket {sel.padded_m:4d} "
                  f"(tile {sel.strategy.l1}, backend {sel.backend}, "
                  f"select {sel_us:.1f}us, max|err|={err:.1e})")

        print("\n== runtime: attention and conv2d through the same session ==")
        for s in (33, 67, 127):
            q = torch.randn(1, 4, s, 64, generator=g).to(dev, dt)
            k = torch.randn(1, 2, s, 64, generator=g).to(dev, dt)
            v = torch.randn(1, 2, s, 64, generator=g).to(dev, dt)
            out = vortex.ops.attention(q, k, v)
            ref = ref_attention(q, k, v, causal=True)
            err = (out.float() - ref.float()).abs().max().item()
            print(f" attention seq={s:4d} -> max|err|={err:.1e}")
        for bsz in (1, 3):
            x = torch.randn(bsz, 14, 14, 16, generator=g).to(dev, dt)
            w = torch.randn(3, 3, 16, 16, generator=g).to(dev, dt)
            out = vortex.ops.conv2d(x, w)
            ref = ref_conv2d(x, w, stride=1, padding="VALID")
            err = (out.float() - ref.float()).abs().max().item()
            print(f" conv2d batch={bsz} -> max|err|={err:.1e}")

    print("\n== engine stats (one cache hierarchy across workloads) ==")
    for kind, s in eng.stats().items():
        print(f" {kind:9s}: {s['signatures']} signature(s), "
              f"{s['selects']} selects ({s['select_cache_hits']} cached), "
              f"{s['exec_entries']} executables for {s['exec_hits']} calls, "
              f"{s['launches']} launches, {s['padded_calls']} padded")


if __name__ == "__main__":
    main()
