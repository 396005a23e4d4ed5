"""The roofline table (markdown) of a dry run's results JSON, one row per
cell of the 16x16 mesh (counterpart of tools/report_tables.py, reading
``python -m repro_torch.launch.dryrun``'s output).  The terms are at the
chip the dry run reported against (the reference's V5E by default).

    python tools/report_tables_torch.py [results/dryrun_torch.json] [--mesh pod2x16x16]
"""
import argparse
import json

ACTIONS = {
    ("collective", "train"): "overlap FSDP gathers / fewer microbatches",
    ("collective", "prefill"): "head-shard KV, pin chunk scan",
    ("collective", "decode"): "sharded flash decode",
    ("memory", "train"): "remat policy: save matmul outputs",
    ("memory", "prefill"): "fuse attention chunks (hand-written kernel)",
    ("memory", "decode"): "at HBM floor (cache streaming)",
    ("compute", "train"): "near roofline: tune the tile via Vortex",
    ("compute", "prefill"): "near roofline",
    ("compute", "decode"): "near roofline",
}


def table(results: dict, mesh: str = "pod16x16") -> str:
    head = (
        "| arch | shape | dominant | compute_s | memory_s | collective_s |"
        " useful | state GiB/dev | action |\n"
        "|---|---|---|---|---|---|---|---|---|\n"
    )
    rows = []
    for key in sorted(results):
        v = results[key]
        if v.get("mesh") != mesh:
            continue
        if "skipped" in v:
            rows.append(f"| {v['arch']} | {v['shape']} | — | — | — | — | — |"
                        " — | skipped: sub-quadratic rule |")
            continue
        if "error" in v:
            rows.append(f"| {v['arch']} | {v['shape']} | failed | — | — | — |"
                        f" — | — | {v['error'][:80]} |")
            continue
        if "roofline" not in v:
            rows.append(f"| {v['arch']} | {v['shape']} | not counted | — | — |"
                        f" — | — | {v['state_gib_per_device']:.2f} | |")
            continue
        r = v["roofline"]
        kind = ("train" if v["shape"].startswith("train")
                else "prefill" if "prefill" in v["shape"] else "decode")
        note = f" ({r['note']})" if r.get("note") else ""
        rows.append(
            f"| {v['arch']} | {v['shape']} | **{r['dominant']}** | "
            f"{r['compute_s']:.4g} | {r['memory_s']:.4g} | "
            f"{r['collective_s']:.4g} | {r['useful_ratio']:.3f} | "
            f"{v['state_gib_per_device']:.2f} | "
            f"{ACTIONS.get((r['dominant'], kind), '')}{note} |"
        )
    return head + "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?", default="results/dryrun_torch.json")
    ap.add_argument("--mesh", default="pod16x16",
                    choices=["pod16x16", "pod2x16x16"])
    args = ap.parse_args(argv)
    with open(args.path) as f:
        print(table(json.load(f), args.mesh))


if __name__ == "__main__":
    main()
