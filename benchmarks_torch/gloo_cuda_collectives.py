"""Which collectives a gloo process group runs on CUDA tensors: two ranks
on one card (both on cuda:0), each op in a 2-rank world of its own, so a
crash names its op.  Prints ``OK <op> rank <r>: <first values>`` or
``FAIL <op>: <why>`` per op; exits 0 once every op has been tried.

This is what decides how a multi-rank DTensor run can use a single card
(NCCL refuses two ranks on one GPU): chip_smoke.py's phase 9b keeps to
the collectives that pass here.

    python benchmarks_torch/gloo_cuda_collectives.py
"""
import os
import sys
import tempfile

import torch
import torch.multiprocessing as mp

OPS = ("c10d_all_reduce", "c10d_all_gather_into_tensor", "c10d_broadcast",
       "funcol_all_reduce", "funcol_all_gather", "funcol_reduce_scatter",
       "dtensor_shard_to_replicate", "dtensor_partial_to_replicate",
       "dtensor_embedding_lookup")


def worker(rank, op, tmp):
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "s"), 2), world_size=2, rank=rank)
    try:
        x = torch.arange(8, dtype=torch.float32, device="cuda") + rank
        if op == "c10d_all_reduce":
            dist.all_reduce(x)
            out = x
        elif op == "c10d_all_gather_into_tensor":
            out = torch.empty(16, device="cuda")
            dist.all_gather_into_tensor(out, x)
        elif op == "c10d_broadcast":
            dist.broadcast(x, 0)
            out = x
        elif op == "funcol_all_reduce":
            out = fc.all_reduce(x, "sum", dist.group.WORLD)
            out = fc.wait_tensor(out)
        elif op == "funcol_all_gather":
            out = fc.wait_tensor(fc.all_gather_tensor(x, 0, dist.group.WORLD))
        elif op == "funcol_reduce_scatter":
            out = fc.wait_tensor(fc.reduce_scatter_tensor(x, "sum", 0,
                                                          dist.group.WORLD))
        else:
            mesh = init_device_mesh("cuda", (1, 2),
                                    mesh_dim_names=("data", "model"))
            if op == "dtensor_shard_to_replicate":
                d = distribute_tensor(x.reshape(2, 4), mesh,
                                      (Replicate(), Shard(0)),
                                      src_data_rank=None)
                out = d.full_tensor()
            elif op == "dtensor_partial_to_replicate":
                d = DTensor.from_local(x, mesh, (Replicate(), Partial()),
                                       run_check=False)
                out = d.redistribute(mesh, (Replicate(), Replicate())) \
                    .to_local()
            else:
                emb = distribute_tensor(torch.randn(
                    16, 4, device="cuda", generator=torch.Generator(
                        "cuda").manual_seed(0)), mesh, (Replicate(), Shard(0)),
                    src_data_rank=None)
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                with implicit_replication():
                    out = emb[torch.tensor([[1, 9]], device="cuda")]
                out = out.full_tensor()
        torch.cuda.synchronize()
        print(f"OK {op} rank {rank}: {out.flatten()[:4].tolist()}",
              flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("gloo_cuda_collectives: needs an NVIDIA GPU")
    print(torch.__version__, torch.version.cuda, flush=True)
    for op in OPS:
        with tempfile.TemporaryDirectory() as tmp:
            try:
                mp.spawn(worker, args=(op, tmp), nprocs=2)
            except Exception as e:  # noqa: BLE001 - a probe: report and go on
                print(f"FAIL {op}: {type(e).__name__}: "
                      f"{str(e).splitlines()[0][:200]}", flush=True)
    sys.exit(0)
