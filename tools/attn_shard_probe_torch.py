"""Micro-harness: the gradient of the plain ``chunked_attention`` on the
fake 512-rank production mesh at deepseek-like shapes, with its
collectives ranked (counterpart of tools/attn_shard_probe.py), for quick
sharding iteration without counting the whole model.  q, k and v are
DTensors laid out ("data", "model", None, None) under FakeTensorMode;
nothing is allocated and no data moves.

    python tools/attn_shard_probe_torch.py [v0|v1|v2] [multi|single]

v0: plain; v1: the attention recomputed in the backward pass
(``torch.utils.checkpoint``); v2: q, k, v and the output pinned to the
layout before and after the attention.  ``single`` runs on the 256-rank
16x16 mesh instead of the reference's 2x16x16: DTensor's search for a
redistribution over three mesh dims takes minutes an op on torch 2.13
(a CPU run of the default did not finish in 12 minutes).
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro_torch.kernels.ref import chunked_attention  # noqa: E402
from repro_torch.launch.dryrun import (  # noqa: E402
    _strided_shards_outside_fake,
    fake_world,
)
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.partitioning import (  # noqa: E402
    PartitionSpec as P,
    replicated_ops,
    spec_to_placements,
)
from repro_torch.roofline.op_counts import OpCounter  # noqa: E402

B, H, S, D, DV = 16, 128, 4096, 192, 128


def main(variant: str = "v0", mesh_name: str = "multi") -> None:
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor

    multi = mesh_name == "multi"
    fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device="cpu")
    pl = spec_to_placements(mesh, P("data", "model", None, None))

    def attn(q, k, v):
        return chunked_attention(q, k, v, causal=True, chunk=1024)

    def pin(t):
        return t.redistribute(mesh, pl)

    if variant == "v1":
        def body(q, k, v):
            return checkpoint(attn, q, k, v, use_reentrant=False)
    elif variant == "v2":
        def body(q, k, v):
            return pin(attn(pin(q), pin(k), pin(v)))
    else:
        body = attn

    with FakeTensorMode(), _strided_shards_outside_fake():
        q, k, v = (distribute_tensor(
            torch.empty(B, H, S, d, dtype=torch.bfloat16), mesh, pl,
            src_data_rank=None).requires_grad_(True) for d in (D, D, DV))
        with OpCounter() as counter, replicated_ops():
            loss = (body(q, k, v).float() ** 2).sum()
            torch.autograd.grad(loss, (q, k, v))
    costs = counter.costs()
    print(f"{variant} ({mesh_name}): coll {costs.collective_bytes / 1e9:.1f} GB/dev  "
          f"flops {costs.flops / 1e12:.2f} TF/dev  "
          f"mem {costs.memory_bytes / 1e9:.1f} GB/dev")
    for kind, nbytes in sorted(costs.collective_by_kind.items(),
                               key=lambda kv: -kv[1]):
        print(f"   {kind:20s} {nbytes / 1e9:10.1f} GB")


if __name__ == "__main__":
    main(*sys.argv[1:3])
