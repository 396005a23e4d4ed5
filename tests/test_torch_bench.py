"""The port's serving snapshot (benchmarks_torch/bench_workloads.py
``serving_payload``) on the CPU, held against the JAX package's bench
sections (benchmarks/bench_workloads.py) on the same requests: the
structural counters — decode tokens, growth copies and bucket transitions,
batched steps per concurrency, MoE launches and padded calls — are equal,
and MoE is bit-identical to the dense einsums.  ``run.py --gate`` fails on
a payload doctored to break each of the reference's gates.

Runs with ``hardware="tpu_v5e"``, the lattice the reference's server
buckets with, so kv buckets and batched steps compare one for one.
"""
import copy
import json

import pytest

pytest.importorskip("jax")
from benchmarks import bench_workloads as ref_bench  # noqa: E402

from benchmarks_torch import run  # noqa: E402
from benchmarks_torch.bench_workloads import serving_payload  # noqa: E402


@pytest.fixture(scope="module")
def payload():
    return serving_payload(True, device="cpu", hardware="tpu_v5e")


def test_payload_sections_and_card(payload):
    assert payload["mode"] == "smoke" and payload["card"] == "cpu"
    for key in ("dispatch", "hot_path", "decode", "continuous_batching",
                "moe"):
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
        assert h["unaligned_extent"] < h["aligned_extent"], kind
        assert h["kernel_launches_per_call"] == 0.0  # plain versions here
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
