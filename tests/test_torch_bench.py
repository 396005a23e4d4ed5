"""The port's serving snapshot (benchmarks_torch/bench_workloads.py
``serving_payload``) on the CPU, held against the JAX package's bench
sections (benchmarks/bench_workloads.py) on the same requests: the
structural counters — decode tokens, growth copies and bucket transitions,
batched steps per concurrency, MoE launches and padded calls, the chained
prefill's bucket, boundary copies and forwarded operands, calibrated
buckets and the persistence roundtrip — are equal, and MoE and the chained
prefill are bit-identical to their references (the dense einsums, the
eager per-op chain).  ``run.py --gate`` fails on a payload
doctored to break each of the reference's gates, the calibration gates
included.

Runs with ``hardware="tpu_v5e"``, the lattice the reference's server
buckets with, so kv buckets and batched steps compare one for one.
"""
import copy
import json

import pytest

pytest.importorskip("jax")
from benchmarks import bench_workloads as ref_bench  # noqa: E402

from benchmarks_torch import run  # noqa: E402
from benchmarks_torch.bench_workloads import (  # noqa: E402
    _bench_calibration,
    serving_payload,
)


@pytest.fixture(scope="module")
def payload():
    """What ``run.py --json`` writes: the serving payload and, beside it,
    the calibration section (on the host CPU's lattice, the reference
    bench's)."""
    p = serving_payload(True, device="cpu", hardware="tpu_v5e")
    p["calibration"] = _bench_calibration(True, device="cpu",
                                          hardware="host_cpu")
    return p


def test_payload_sections_and_card(payload):
    assert payload["mode"] == "smoke" and payload["card"] == "cpu"
    for key in ("dispatch", "hot_path", "decode", "continuous_batching",
                "prefill_chain", "moe", "calibration"):
        assert payload[key], key
    assert set(payload["dispatch"]) == set(payload["hot_path"]) == {
        "gemm", "attention", "conv2d"}
    json.dumps(payload)  # what run.py --json writes


def test_dispatch_serves_unseen_extents_from_the_table(payload):
    for kind, d in payload["dispatch"].items():
        assert d["stream_len"] == 60 and d["table_entries"] > 0, kind
        assert d["speedup"] >= run.DISPATCH_SPEEDUP, (kind, d)


def test_hot_path_counters_keep_the_reference_meanings(payload):
    """One launch per call, no padded call, and the reference's boundary
    copies per unaligned call: one stage per dynamic operand plus one
    unstage of the output (q, k and v for attention)."""
    copies = {"gemm": 2.0, "attention": 4.0, "conv2d": 2.0}
    for kind, h in payload["hot_path"].items():
        assert h["launches_per_call"] == 1.0, kind
        assert h["padded_calls"] == 0 and h["fallbacks"] == 0, kind
        assert h["copies_per_unaligned_call"] == copies[kind], kind
        assert h["folded_per_unaligned_call"] == 0.0, kind  # the card's
        assert h["unaligned_extent"] < h["aligned_extent"], kind
        assert h["kernel_launches_per_call"] == 0.0  # plain versions here
        assert h["stage_launches_per_unaligned_call"] == 0.0
        assert len(h["samples"]["aligned_us"]) >= 20


def test_decode_counters_match_the_reference(payload):
    ref = ref_bench._bench_decode(True)
    got = payload["decode"]
    for key in ("tokens", "launches_per_token", "padded_calls",
                "growth_copies", "bucket_transitions",
                "decode_exec_buckets"):
        assert got[key] == ref[key], key
    assert got["decode_buckets"] == ref["decode_compiles"]
    assert got["engine_padded_calls"] == ref["engine_padded_calls"] == 0
    assert got["engine_launches_per_token"] == got["n_layers"]


def test_graph_counters_cover_the_timed_windows(payload):
    """The CPU runs the eager step: no capture and no replay anywhere; the
    timed windows hold every decode step the reference's would."""
    dec, cb = payload["decode"], payload["continuous_batching"]
    for r in (dec, cb):
        assert r["graphs"] is False
        assert r["decode_graph_captures"] == r["decode_graph_replays"] == 0
        assert r["prefill_graph_captures"] == r["prefill_graph_replays"] == 0
    assert dec["timed_steps"] == dec["tokens"] - dec["tokens"] // 2
    serial = cb["requests"] * (cb["max_new"] - 1)
    assert cb["timed_steps"] == serial + sum(
        c["batched_steps"] for c in cb["concurrency"].values())
    p = _passing(payload)
    for r in (p["decode"], p["continuous_batching"]):
        r.update(graphs=True, decode_graph_replays=r["timed_steps"])
    assert run.gate_failures(p) == []


def test_continuous_batching_steps_match_the_reference(payload):
    ref = ref_bench._bench_continuous_batching(True)
    got = payload["continuous_batching"]
    assert got["requests"] == ref["requests"] == 16
    for c in ("1", "4", "16"):
        g, r = got["concurrency"][c], ref["concurrency"][c]
        assert g["batched_steps"] == r["batched_steps"], c
        assert g["launches_per_batched_step"] == \
            r["launches_per_batched_step"] == 1.0, c
        assert g["padded_calls"] == r["padded_calls"] == 0, c
    assert got["kv_pool"]["leases_active"] == 0
    assert got["kv_pool"]["lease_allocs"] == ref["kv_pool"]["lease_allocs"]


def test_moe_launches_match_the_reference_and_are_bit_identical(payload):
    ref = ref_bench._bench_moe(True)
    got = payload["moe"]
    for key in ("experts", "top_k", "d_ff_expert", "tokens", "layer_calls",
                "launches_per_moe_layer", "padded_calls"):
        assert got[key] == ref[key], key
    assert got["launches_per_moe_layer"] == 1.0
    assert got["bit_identical_to_dense"] and ref["bit_identical_to_dense"]
    assert got["dropped_frac"] == pytest.approx(ref["dropped_frac"])


def test_prefill_chain_matches_the_reference(payload):
    """The same smoke prefill (batch 1, prompt 100) through both packages'
    chains: the same chain-aligned bucket, zero boundary copies, the same
    forwarded operands, and bit-identity to the eager per-op chain."""
    ref = ref_bench._bench_prefill_chain(True)
    got = payload["prefill_chain"]
    for key in ("seq_bucket", "batch_bucket", "blocks_per_prefill",
                "chain_aligned", "boundary_copies_per_block",
                "forwarded_per_prefill", "bit_identical_to_eager"):
        assert got[key] == ref[key], key
    assert got["chain_aligned"] and got["boundary_copies_per_block"] == 0
    assert got["bit_identical_to_eager"]
    assert got["kernel_launches_per_prefill"] == {}  # plain versions here
    assert got["aot_graphed_us_per_prefill"] is None  # no graphs here
    assert got["aot_eager_us_per_prefill"] > 0


def test_calibration_matches_the_reference(payload):
    """The same gemm, calibrated on the host CPU's lattice by both
    packages: the same kinds and measured buckets, never worse than the
    analytical pick, and a fresh engine loads the tables with zero
    re-measurements."""
    ref = ref_bench._bench_calibration(True)
    got = payload["calibration"]
    assert set(got["kinds"]) == set(ref["kinds"]) == {"gemm"}
    for kind, r in got["kinds"].items():
        assert r["measured_buckets"] == ref["kinds"][kind]["measured_buckets"]
        assert r["never_worse_on_measured"]
        assert [b["m"] for b in r["buckets"]] == \
            [b["m"] for b in ref["kinds"][kind]["buckets"]]
    for key in ("loaded", "re_measurements", "pending_after_load",
                "table_swaps"):
        assert got["roundtrip"][key] == ref["roundtrip"][key], key
    assert got["roundtrip"]["loaded"] == 1
    assert got["stats"]["applied"] == got["stats"]["saves"] == 1


def _passing(payload) -> dict:
    """The CPU payload with its wall-clock ratios set inside the gates
    (their CPU values are host noise, not a card's); every structural
    counter is the measured one."""
    p = copy.deepcopy(payload)
    for h in p["hot_path"].values():
        h["unaligned_over_aligned"] = 1.0
    p["continuous_batching"]["speedup_at_16"] = 2.0
    return p


def _set(path, value):
    def doctor(p):
        *keys, last = path
        node = p
        for k in keys:
            node = node[k]
        node[last] = value
    return doctor


def _graphed(section, captures, missing=0):
    """The section as the card writes it (graphs on, one replay a timed
    step), with ``captures`` captures and ``missing`` replays short."""
    def doctor(p):
        r = p[section]
        r.update(graphs=True, decode_graph_captures=captures,
                 decode_graph_replays=r["timed_steps"] + missing)
    return doctor


DOCTORS = {
    "dispatch_speedup": _set(("dispatch", "gemm", "speedup"), 4.0),
    "hot_launches": _set(("hot_path", "attention", "launches_per_call"), 2.0),
    "hot_padded": _set(("hot_path", "gemm", "padded_calls"), 1),
    "hot_ratio": _set(("hot_path", "conv2d", "unaligned_over_aligned"), 1.2),
    "hot_fallbacks": _set(("hot_path", "gemm", "fallbacks"), 1),
    "decode_steps": _set(("decode", "launches_per_token"), 2.0),
    "decode_padded": _set(("decode", "padded_calls"), 1),
    "decode_engine_padded": _set(("decode", "engine_padded_calls"), 1),
    "cb_steps": _set(("continuous_batching", "launches_per_batched_step"),
                     2.0),
    "cb_padded": _set(("continuous_batching", "padded_calls"), 1),
    "cb_speedup": _set(("continuous_batching", "speedup_at_16"), 1.4),
    "moe_launches": _set(("moe", "launches_per_moe_layer"), 3.0),
    "moe_padded": _set(("moe", "padded_calls"), 1),
    "moe_bits_cpu": _set(("moe", "bit_identical_to_dense"), False),
    "decode_graph_captured_in_window": _graphed("decode", 1),
    "cb_graph_step_not_replayed": _graphed("continuous_batching", 0, -1),
    "calibration_worse": _set(
        ("calibration", "kinds", "gemm", "never_worse_on_measured"), False),
    "calibration_unmeasured": _set(
        ("calibration", "kinds", "gemm", "measured_buckets"), 0),
    "calibration_roundtrip_remeasures": _set(
        ("calibration", "roundtrip", "re_measurements"), 2),
    "calibration_roundtrip_pending": _set(
        ("calibration", "roundtrip", "pending_after_load"), True),
    "calibration_missing": lambda p: p.pop("calibration"),
    "chain_copies": _set(("prefill_chain", "boundary_copies_per_block"), 1.5),
    "chain_not_forwarded": _set(("prefill_chain", "forwarded_per_prefill"),
                                0),
    "chain_not_bit_identical": _set(
        ("prefill_chain", "bit_identical_to_eager"), False),
    "chain_missing": lambda p: p.pop("prefill_chain"),
}


def test_gate_passes_a_payload_inside_every_gate(payload, tmp_path):
    p = _passing(payload)
    assert run.gate_failures(p) == []
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(p))
    assert run.main(["--check", str(path), "--gate"]) == 0


@pytest.mark.parametrize("name", list(DOCTORS))
def test_gate_fails_a_payload_doctored_to_break_it(payload, tmp_path, name):
    p = _passing(payload)
    DOCTORS[name](p)
    failures = run.gate_failures(p)
    assert len(failures) == 1, failures
    path = tmp_path / "snap.json"
    path.write_text(json.dumps(p))
    assert run.main(["--check", str(path), "--gate"]) == 1


def test_gate_on_the_card_holds_moe_to_the_tolerance(payload):
    """On the card the MoE gate is the bf16 tolerance, not bit-identity."""
    p = _passing(payload)
    p["device"] = "cuda:0"
    p["moe"]["bit_identical_to_dense"] = False
    assert run.gate_failures(p) == []
    p["moe"]["within_tolerance"] = False
    assert len(run.gate_failures(p)) == 1
