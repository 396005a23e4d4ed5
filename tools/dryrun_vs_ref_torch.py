"""The port's dry-run counts against the reference's, cell by cell, as a
markdown table: per-device FLOPs, collective bytes (by kind) and the
dominant roofline term, each with the port-over-reference ratio.  A
prefill's FLOPs are also held against the reference's less the rows its
prefill projects onto the vocabulary and the port's does not (all but
the last: the port reads row s - 1 before its head), "same work".

    python tools/dryrun_vs_ref_torch.py PORT.json REF.json [--before BEFORE.json]

PORT.json (and BEFORE.json, an earlier tree's) is the output of
``python -m repro_torch.launch.dryrun --mesh single --groups 1 --force
--out PORT.json``; REF.json that of ``python tests/dryrun_ref_oracle.py
REF.json all`` (the reference's ``lower_cell`` on a 16x16 Auto-axis mesh
of forced host devices, cut to one layer group).
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.models.config import SHAPES  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402

KINDS = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS",
         "all-to-all": "A2A", "collective-permute": "CP"}


def _kinds(by_kind: dict) -> str:
    return " ".join(f"{KINDS.get(k, k)} {v:.3g}"
                    for k, v in sorted(by_kind.items()) if v)


def same_work_flops(arch: str, shape_name: str, ref_flops: float) -> float:
    """The reference's FLOPs a device of the 16x16 mesh less, in a
    prefill, its head over every row but the last (the batch over 16 data
    ranks, the vocabulary over 16 model ranks)."""
    shape = SHAPES[shape_name]
    if shape.kind != "prefill":
        return ref_flops
    cfg = get_config(arch)
    rows = shape.global_batch // 16 * (shape.seq_len - 1)
    return ref_flops - 2 * rows * cfg.d_model * cfg.vocab_padded / 16


def _port(results: dict, arch: str, shape: str):
    r = results.get(f"{arch}|{shape}|single", {})
    if "error" in r:
        return "error"
    return r.get("roofline")


def _cell(roof) -> tuple:
    if roof is None:
        return ("—",) * 4
    if roof == "error":
        return ("error",) * 4
    return (f"{roof['flops']:.3g}", f"{roof['collective_bytes']:.3g}",
            _kinds(roof["collective_by_kind"]), roof["dominant"])


def table(port: dict, ref: dict, before: dict | None = None) -> str:
    b = before is not None
    head = (["arch", "shape"] + ["FLOPs before"] * b
            + ["FLOPs", "ref FLOPs", "ratio", "same work"]
            + ["coll before"] * b + ["coll", "ref coll", "ratio"]
            + ["kinds before"] * b + ["kinds", "ref kinds"]
            + ["dominant before"] * b + ["dominant", "ref dominant"])
    lines = ["| " + " | ".join(head) + " |",
             "|" + "---|" * len(head)]
    for key in ref:
        arch, shape = key.split("|")
        rr, pr = ref[key], _port(port, arch, shape)
        if "error" in rr:
            lines.append(f"| {arch} | {shape} | reference error: "
                         f"{rr['error'][:60]} |")
            continue
        f, c, k, d = _cell(pr)
        ok = isinstance(pr, dict)
        old = _cell(_port(before, arch, shape)) if b else ()
        row = [arch, shape, *old[:1]]
        same = same_work_flops(arch, shape, rr["flops"])
        row += [f, f"{rr['flops']:.3g}",
                f"{pr['flops'] / rr['flops']:.3g}" if ok else "—",
                f"{pr['flops'] / same:.3g}" if ok and same != rr["flops"]
                else ""]
        row += [*old[1:2], c, f"{rr['collective_bytes']:.3g}",
                (f"{pr['collective_bytes'] / rr['collective_bytes']:.3g}"
                 if ok and rr["collective_bytes"] else "—"),
                *old[2:3], k, _kinds(rr["collective_by_kind"]),
                *old[3:4], d, rr["dominant"]]
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("port")
    ap.add_argument("ref")
    ap.add_argument("--before", default=None)
    args = ap.parse_args(argv)
    load = lambda p: json.load(open(p))  # noqa: E731
    print(table(load(args.port), load(args.ref),
                load(args.before) if args.before else None))


if __name__ == "__main__":
    main()
