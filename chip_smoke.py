"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):

1. Build the hand-written kernels from src/repro_torch/csrc (nvcc, sm_90a)
   and print the card's name and power limit.
2. Hold each kernel against its plain PyTorch version on the card, in
   bfloat16 and float32: the GEMM with NaN-poisoned m_true tails and N/K
   tails that do not divide the block; attention causal and not, window,
   softcap, GQA (granite's 16/8 heads too), per-row kv_len including 0,
   NaN K/V tails past kv_len, and decode with q_offset; the wgmma prefill
   kernel at block_q 64-1024 (several warpgroups and rounds, q rows past
   sq), block_k 16-512 and d = 16, 64, 120, 128 and 256 over GQA groups of
   1, 2, 3, 4 and 12, windows and softcap, and the split-kv decode
   kernel from 1 to many splits, each decode case called twice (its tickets
   must be reset) and also held against its split-kv plain version.  Every
   attention case runs under each backend its tile admits and must take the
   path (prefill.tensor_core, prefill.cuda_core, decode.split_kv) that its
   form, backend and dtype name; the model's decode attention at gemma2's
   shape over a cache past twice the window, rows at positions whose
   windows start apart (one clamped at 0), through the per-row window
   slice and one split-kv launch, against its inline math;
   the grouped GEMM with NaN past each group's count, counts of 0, 1,
   partial and C, r = G/E of 1 and more, K/N tails, and rows past each
   count exactly 0.  Every GEMM and grouped case runs under each backend
   its tile admits (``cuda_core`` always; ``tensor_core`` at multiples of
   the (64, 8, 16) wgmma atom, which bf16 runs as wgmma and float32 as the
   FMA loop), and each launch must take the path its backend and dtype
   name.  The tensor-core cases include a NaN tail inside a 64-row atom
   (m_true 77; counts 1, 5, 17, 33), ragged K/N (K = 70, N = 50 at
   (64, 8, 16)), the largest accumulator (64, 512, 16), (512, 32, 64) at
   conv2_x, and (64, 8, 64) at granite's expert widths.  The dispatch
   engine's staging copy (csrc/stage.cu) stages one, two and three
   operands in one launch into NaN-poisoned buffers, bf16 and float32
   (16-byte words and the byte path), bit-identical to one ``copy_`` per
   operand with the pad tails untouched.
3. Main path 1: ``vortex.ops.gemm`` at dynamic M in {1, bucket-1, bucket,
   bucket+1, a prime} — exactly one kernel launch per call, 0 padded calls,
   and every unaligned call launched on its own operand: 0 staging
   launches (csrc/stage.cu), 0 copies, one ``folded_stages`` and one
   ``folded_unstages`` a call, no staging set made.
   Phases 3, 3b, 4 and 4b also check that every bf16 launch of the GEMM,
   the grouped GEMM and prefill attention took the tensor-core path, and
   every decode-attention launch the split-kv kernel (the launch counters).
3b. Main path 1b: ``vortex.ops.conv2d`` at ResNet-50 shapes (He et al.
   2016, Table 1; bf16, batch 1, 3, 8): conv2_x 3x3 64->64 on 58x58 and
   conv3_x 3x3 128->128 stride 2 on 57x57 — one GEMM launch per call,
   0 padded calls, agreement with the plain version, and phase 3's
   checks of the unaligned calls (the im2col matrix read in place).
3c. Every kernel path of an engine dispatch at a true extent one row
   below its bucket, launched on the caller's own operands (allocations
   that run on in NaN past the operand): the GEMM at ``tensor_core`` and
   ``cuda_core`` in bf16 and float32 (N = K = 768), the grouped GEMM at
   both backends (granite's widths, counts of 0, C - 1, C and seeded ones,
   NaN past each count), prefill attention at both backends (paper-gpt2's
   12 heads of 64), decode with a per-row kv_len (0 and the whole cache
   among the rows) and with one kv_len, and conv2d (3x3, 64 -> 64).  Each
   makes one launch on the path its backend and dtype name, no staging
   launch and no pool set, counts its operands off the bucket as
   ``folded_stages``, and is bit-identical to ``call_padded``.
4. Main path 2: ``VortexServer`` serving paper-gpt2-124m at full width
   (seeded torch init), 8 requests of batch 1-8 and prompt 4-64,
   max_new 8, max_cache 256, after ``warmup`` captured the decode graph
   of every reachable (batch, kv) bucket — one decode step per token, each
   one replay of a warmed CUDA graph (0 captures in the run), n_layers
   decode-attention launches per token, 0 padded calls, 0 stage copies at
   aligned kv buckets; one request's prefill and decode logits against
   the same server with impl="torch".
4b. Main path 3: the same on granite-moe-1b-a400m at full width (24
   layers, 32 experts top-8): also 3 grouped-GEMM launches per layer per
   forward (72), 0 padded grouped calls, the mean dropped_frac, and the
   share of (token, choice) expert assignments that differ between the
   impl="cuda" and impl="torch" runs.
4c. Main path 4: ``ContinuousScheduler(batch_rows=8)`` over a
   ``VortexServer`` of gemma2-9b at full width and depth (42 layers,
   seeded bf16 init on the card): 16 requests from
   ``np.random.default_rng(0)`` of 1-4 rows, prompts of 16-512 tokens and
   max_new 4-32, all submitted, then drained.  Fails unless every request
   returns a token array of its shape, every batched step is one replay of
   a vector-form decode graph and makes exactly 42
   ``decode_attention`` launches on ``decode.split_kv``, every prefill
   launch takes ``prefill.tensor_core``, padded calls are 0, the pool's
   ``leases_active`` is 0 after ``close()``, and one mixed-progress step's
   logits (rows at different positions) agree with the same step under
   impl="torch" from a copy of the same cache.  Prints the wall time, the
   steps, tokens and rows per step, and the init, warmup and serve
   seconds (serve split into prefills, decode steps and the rest).
4d. The same server, one request of batch 1 and a prompt of 8,300 tokens
   (max_new 4) through a one-row scheduler: its kv bucket passes twice
   gemma2's window of 4096, so the local layers' prefill masks by the
   window and their decode reads the window slice; its decode logits are
   held against impl="torch" from the same cache.
4e. h2o-danube-3-4b (head_dim 120, ROADMAP C3), phi4-mini-3.8b (a GQA
   group of 3) and starcoder2-15b (a group of 12), each at full width and
   2 layers, 4 requests each through the scheduler, with 4c's checks.
4f. gemma2-9b at full width, 2 layers, in float32: the scheduler's tokens
   equal serial ``generate()``'s on the same server for the same
   requests.
4g. Graphed against eager (``VortexServer(graphs=False)`` on the same
   weights), from copies of the same cache: phase 4's paper-gpt2-124m and
   4b's granite-moe-1b-a400m (grouped GEMM and ``dropped_frac`` inside the
   graph) step by step with a scalar ``pos``, 3 rows, through a growth
   into the next kv bucket, then ``generate()``; and (in phase 4c)
   gemma2-9b's compared mixed-progress step with a vector ``pos``.  Every
   step's logits must be bit-identical and the tokens identical.
4i. Graphed "aot" prefills against eager ones (``graphs=False``, the same
   weights) on phase 4's and 4b's servers at (rows, prompt) (1, 64),
   (2, 100) and (4, 37): first-token logits, ``dropped_frac`` and every
   cache leaf bit-identical.  Phases 4 and 4b also fail unless every
   prefill after ``warmup`` is one replay of a warmed prefill graph, and
   4c-4f unless every admission's prefill is one replay.
4h. ``VortexServer(prefill="chained")`` on phase 4's paper-gpt2-124m
   weights at (1, 100), (2, 100) (chain bucket 128) and (1, 150) (seq
   bucket 192, chain bucket 256): 0 stage, unstage and realize copies,
   ``forwarded >= n_layers``, exactly 73 tensor-core GEMM and 12
   tensor-core prefill-attention launches a prefill, logits and cache
   bit-identical to ``eager=True``, first-token logits within LOGIT_TOL
   of the "aot" prefill; NaN-tailed handles forwarded into the GEMM,
   prefill attention and decode attention (over the chain's own k/v
   buffers), each bit-identical to the engine's call on the true-extent
   operands and within tolerance of the plain version; a handle whose
   buffer is off its bucket restages and a lazy output at an unaligned
   extent stages (one ``stage_copy`` launch each, the launches row 5
   reports), each bit-identical to the folded call; two chained
   ``generate()`` runs, every decode
   step one replay; then gemma2-9b at full width with 2 layers through
   the chain (window 4096, softcaps 50/30, d = 256).
4j. MLA and Mamba: deepseek-v2-236b (MLA, 2 shared and 160 routed
   experts top-6; 2 of 60 layers), falcon-mamba-7b (64 Mamba layers,
   full depth) and jamba-v0.1-52b (one 8-layer group: 7 Mamba layers and
   1 attention layer, 4 MoE layers of 16 experts top-2), each at full
   width, bf16, seeded init drawn on the card, max_cache 512, through
   serial ``generate()`` with graphs on: 4 requests of 1-2 rows, prompts
   of 16-256 tokens that fall short of their seq bucket, max_new 8.
   Fails unless the graphed tokens equal an eager server's
   (``graphs=False``, the same weights) bit for bit, every prefill and
   decode step is one graph replay, jamba's attention launches (1 a
   forward) take the tensor-core prefill and split-kv decode paths, the
   grouped GEMM launches 3 times per MoE layer per forward on the
   tensor cores, and the C11 check passes: a 37-token prompt's prefill
   padded to its 64-row bucket against its exact-length prefill (no-drop
   MoE capacity), the first Mamba layer's state within 2^-7 in bf16, the
   whole model's logits and Mamba state within 5e-2 in bf16 (deepseek,
   jamba) or within 1e-5 on a float32 copy of the weights (falcon-mamba,
   whose 64 random-weight layers grow the two lengths' bf16 rounding
   differences past 5e-2).  Rows for the grouped GEMM at deepseek's and
   jamba's shapes and for jamba's attention, each held against its plain
   version first.  Prints the device time per call of the plain-torch
   code the new mixers run on the card (MLA's prefill
   ``chunked_attention`` and absorbed decode, the Mamba chunk scan and a
   Mamba layer's prefill and decode), each architecture's prefill and
   decode step in CUDA-event ms and its peak_gb.
4k. The encoder, cross-attention and the vision prefix: whisper-small
   at full width and depth (12 encoder layers over 1500 frames, 12
   decoder layers with cross-attention, sinusoidal positions, tied head;
   max_cache 512) and internvl2-26b at full width with 2 of its 48 layers
   (48/8 heads of 128, a 256-row vision prefix; max_cache 1024), bf16,
   seeded init drawn on the card, the frontends fed zeros as the
   reference's stub does, through serial ``generate()`` with graphs on:
   4 requests each, short of their seq bucket (whisper 1-4 rows, prompts
   3-40, max_new 16; internvl2 1-2 rows, prompts 257-400, max_new 8).
   Fails unless the graphed tokens equal an eager server's bit for bit,
   every prefill and decode step is one graph replay, each prefill makes
   one non-causal B2 launch per encoder layer and one causal launch per
   decoder layer and each decode step one split-kv launch per decoder
   layer (the engine's per-form counts, and the kernels' counters),
   every launch takes the tensor-core or split-kv path, the first-token
   logits agree with ``impl="torch"`` on the same weights within
   LOGIT_TOL, the encoder's B2 call at 1500 frames agrees with the inline
   ``chunked_attention`` within 2^-6, and a 100-token internvl2 prompt
   raises ``VisionPrefixError`` (C13) with the pool's ledger unmoved.
   Prints the device time per call of the plain-torch code the new
   modules run (the sinusoids, one layer's cross K/V projection, the
   cross-attention of a prefill and of a decode step, the whole encoder,
   the vision-prefix overwrite), each model's prefill and decode step in
   CUDA-event ms and its peak_gb.  Rows for B2 at the encoder's shape
   (non-causal, SDPA without a mask as its library call), whisper's
   decoder and internvl2's (GQA group 6).
5. Time each kernel at the main path's shapes and selected strategy
   beside its plain version, its bound and one PyTorch library call
   computing the same function (device time per call from torch.profiler);
   attention at both servers' shapes (paper-gpt2's 12/12 heads, granite's
   16/8, whose K/V bytes count over the kv heads), gemma2's local-layer
   prefill (d = 256, window and softcap) and mixed-progress decode
   (per-row kv_len), and danube's prefill at d = 120.  gemma2's library
   time is one compiled ``flex_attention`` call (a tanh softcap
   ``score_mod``, a causal-window or per-row kv_len block mask,
   ``enable_gqa``), held against the plain version before it is timed.
   The staging copy at the hot path's attention shape (three operands),
   its library call one ``torch._foreach_copy_``.  Rows 1b
   and 1c: the chain's MLP-in GEMM (K 768, N 3072) and LM head (K 768,
   N 50432) at m = 128, beside ``torch.matmul``.  Rows 1, 1b, 1c and 4
   also time the tensor-core GEMM's cp.async kernel at the same tile
   (``cp_async_ms``, ``vortex_gemm(tma=False)``).  Row 1d: the GEMM
   stream's dominant call (M 1,024, K = N = 3,072) at the tile the
   lattice selects there, (512, 32, 64): the TMA kernel with and without
   the A multicast, the cp.async kernel and ``torch.matmul``, each 20
   launches captured in a CUDA graph on weights rotated out of L2 and
   timed with CUDA events, in turns; and the same shape at square tiles,
   (128, 128, 64) and (128, 256, 64).  ``python3 chip_smoke.py
   --gemm-rows`` builds the kernels and runs phases 3 and 3b and rows 1,
   1b, 1c, 1d and 4 alone (rows 1b and 1c at a default engine's tiles,
   their launch counts not taken).
6. The benchmark suite's serving snapshot at full width on the card
   (``benchmarks_torch.bench_workloads.serving_payload(smoke=False)``, the
   payload ``benchmarks_torch/run.py --json`` writes): the hot path's
   aligned and unaligned dispatch of a bf16 GEMM (2304 wide), prefill
   attention (8/4 heads of 64) and a 1x1 conv2d (1536 wide); decode and
   continuous batching (serial, then concurrency 1, 4, 16) on
   paper-gpt2-124m at 12 layers; one granite-moe-1b-a400m expert-FFN
   layer at its real widths (1024/512, 32 experts, top-8); one chained
   paper-gpt2 prefill (``prefill_chain``: 0 boundary copies, 73 GEMM and
   12 prefill launches, bit-identical to eager, beside the graphed and
   eager "aot" prefill's µs), with 0 prefill captures in the timed
   windows.  Fails unless
   every engine call is one engine launch and one kernel launch with 0
   padded calls and every unaligned call no staging launch and no copy
   (its 2, 4 or 2 boundaries all folded into the launch), every token
   and every batched step is one decode step of
   12 ``decode_attention`` launches with 0 padded calls, every decode
   step inside the timed windows one graph replay with 0 captures, every MoE
   projection is one grouped launch for all experts, the kv pool's leases
   are back to 0, the MoE layer agrees with the dense einsums within the
   grouped GEMM's bf16 tolerance, and each of the four kernels launched at
   least once in the phase.  Prints each section's timings (the
   hot-path ratios, tokens/s and ``speedup_at_16``, select µs) beside the
   card's name and power limit; the reference's wall-clock gates are
   ``benchmarks_torch/run.py --gate``'s, not this script's.
6b. Background calibration (core/calibrate.py) on the card, bf16.  An
   engine with ``calibration="on-idle"`` and a fresh cache directory
   serves the main path's shapes once (the gemm at N = K = 768, the conv
   at ResNet-50's conv2_x, the grouped GEMM at granite's expert widths,
   paper-gpt2's prefill attention), then ``run_calibration``.  Fails
   unless gemm, conv2d and the grouped GEMM each measured a bucket and
   never pick slower than the analytical pick there, attention is skipped
   as exec-specialized, every measurement launch took the path its
   candidate's backend names (the launch counters equal the measured
   candidates' launches per path exactly), each kind's output after the
   swap agrees with its plain version, and a second engine on the same
   cache loads every table with no measurement and nothing pending.
   Prints per kind the fit's mode, residual and coefficients, the
   agreement rate, pinned/measured buckets and regret, and per bucket the
   host µs (``interleaved_minima``) of the analytical, best and
   calibrated picks beside the device µs of the analytical and calibrated
   picks.  Then granite-moe-1b-a400m at full width and depth behind
   ``ContinuousScheduler(batch_rows=8)`` on a calibrating engine: 8
   requests (prompts 16-128, max_new 8), idle ticks until nothing is
   pending (at most 200), 8 more requests (prompts 160-384).  Fails
   unless idle ticks donated slices and none ran while a row was active
   or a request queued, every grouped-GEMM signature swapped its table,
   every decode step is one graph replay, one step's logits after the
   swap agree with impl="torch" within LOGIT_TOL, and the kv pool's
   leases are back to 0.  Prints each slice's wall time against the
   budget, the grouped GEMM's analytical and calibrated tile at each
   served capacity bucket, and rows 3a/3b's device time under both.
7. Failure domains on the card (core/engine.py's degradation ladder,
   core/denylist.py, launch/graphs.py's ladder-aware capture).
   ``tools/chaos_torch.py`` runs in-process for seeds 0-2 (phase A: a
   bf16 ``vortex.ops.gemm`` stream at K = N = 768 under seeded
   precompile/aot_launch faults, within 2^-7 of a float32 matmul; phase
   B: paper-gpt2-124m at full width with graphs on, float32, behind
   ``ContinuousScheduler`` under pool_lease/scheduler_step faults: every
   request resolves, non-faulted tokens equal serial ``generate()``'s,
   0 leases after close).  A gemm call with every precompile and
   aot_launch occurrence failing raises ``LadderExhaustedError`` after
   1 + max_kernel_retries hand-written candidates (operands on the card
   never reach a plain version: no ``vortex_gemm`` launch, no fallback,
   its quarantines rolled back, no denylist file), and the same call with
   no plan is right again.  A call whose best candidate fails at launch
   walks one rung (one quarantine, within 2^-7 of the plain version) and
   persists it; a fresh ``Engine`` on the same cache directory loads the
   denylist and serves the same call with 0 quarantine events and one
   kernel launch.  A fault aimed at the first launch inside a decode
   step's capture: the ladder quarantines once, the capture is taken
   again, the graphed logits equal the eager step's (``graphs=False`` on
   the same engine) bit for bit, and a replay fires no fault site.
   Prints the host µs of a healthy gemm call, of a call that walked one
   rung and of a call that exhausted the ladder, with the card's name
   and power limit.  After every earlier phase, and again after this
   one, the script fails unless the ladder never fired on any engine
   kernel built before phase 7 (``fallbacks == quarantined == 0``, no
   plan installed; running totals, so a server reused by a later phase
   is held there too): a quarantine there would hide a kernel that fails
   on the main path.  The script points ``VORTEX_CACHE_DIR`` at a
   temporary directory, so no denylist from an earlier run steers a
   selection.
8. Training (src/repro_torch/launch/train.py, train/step.py; no kernel
   lies on the reference's train path, so autograd runs plain torch on
   the card).  paper-gpt2-124m at full width and depth (12 layers, d 768,
   vocab 50,257, bf16, seeded init on the card) through ``build_trainer``
   and the ``Supervisor`` at the launcher's defaults: batch 8, seq 128, 2
   microbatches, remat, lr 3e-4, 50 steps, a checkpoint every 20 into a
   temporary directory.  First the gradients of step 0's batch: every
   leaf present, float32, finite and not all zero; one bf16 step against
   a float32 step from the same weights and batch (losses within
   BF16_LOSS_TOL); the device time of one step.  Then the launcher's run
   on its stream over the whole vocabulary (timed: ms a step, tokens/s,
   ``max_memory_allocated``; every loss finite and below ln(vocab) + 1;
   checkpoints at 20 and 40).  Then the same run on the stream's tokens
   restricted to the first LEARN_VOCAB ids, uninterrupted and with a
   ``SimulatedFailure`` before step 30, both under
   ``torch.use_deterministic_algorithms``: the mean of its last 5 losses
   below its first 5's by LOSS_MARGIN, 1 failure and 1 restore from step
   20, the replayed steps' batches identical, the final loss and every
   parameter and moment bit-identical to the uninterrupted run, and the
   trained state through ``CheckpointManager`` bit-exact (bf16 included).
   Then granite-moe-1b-a400m at full width, 4 of its 24 layers, 5 steps
   of one microbatch: its gradients (the expert stacks' included) finite
   and not all zero, ``aux`` positive and ``dropped_frac`` finite.  Fails
   if a vortex session is installed or ``launch_counts()`` moves.
9. Distribution (launch/mesh.py, models/partitioning.py, the sharded
   train step, ``flash_decode_sharded``; no kernel lies on the
   reference's distribution path).  9a: paper-gpt2-124m at full width
   and depth through ``build_trainer(mesh=make_host_mesh())``, a 1x1
   DeviceMesh on a 1-rank NCCL group (parameters DTensors, moments laid
   out by ``opt_state_pspecs``), 5 steps of the launcher's stream at its
   defaults: each loss within 1e-3 relative of phase 8's, beside a plain
   run of the same steps (whether bit-identical, the largest parameter
   difference after step 5), ms and device ms a step; the group is
   destroyed at the end.  9b: two spawned ranks on the one card, a gloo
   group over a FileStore, ``init_device_mesh("cuda", (1, 2))`` (data 1,
   model 2) with the rules of the production TP of 16, where neither 4
   nor 8 kv heads divide the model axis, so the cache shards on sequence.
   ``flash_decode_sharded`` on bf16 DTensor caches placed by
   ``cache_pspecs`` at starcoder2-15b's decode heads (48/4 of 128, batch
   8, 16,384 rows) and gemma2-9b's local layer (16/8 of 256, window 4096,
   softcap 50, batch 8, 8,192 rows), at the first, middle and last
   position: the output within 2^-6 of the unsharded ``_decode_attend``,
   the cache writes exact at the owning rank only.  Then one
   ``decode_step(rules=)`` of starcoder2-15b at full width with 2 layers
   on DTensor weights and caches (the model's seq-sharded branch) against
   the plain ``decode_step``: logits and the new cache row within 5e-2,
   every other row exact.  9c: ``VortexServer(mesh=make_host_mesh())`` on
   phase 4's weights serves phase 4's requests: tokens identical, B2
   launched 12 times a prefill and a token, every decode step a graph
   replay.
10. Analysis and the direct kernel wrappers.  10a: ``kernels/ops.py``
   (``matmul``, ``attention``, ``conv2d``: no engine) in bf16 and float32
   under both backends, at row 1b's GEMM (M 128 with m_true 100, K 768,
   N 3072), paper-gpt2's prefill q (8, 12, 64, 64) causal and its decode
   form (one query row over a 256-row cache, per-row kv_len, block_q 1)
   and ResNet-50's conv2_x at b = 8: every call moves
   ``launch_counts()`` by exactly one launch of its kernel on the path
   its dtype and backend name and agrees with its plain version at phase
   2's tolerances; each wrapper timed (torch.profiler device time) beside
   its plain version, bound and library call.  10b: the serve-step
   builders (``make_prefill_step``/``make_decode_step``) on the 1x1 NCCL
   mesh, paper-gpt2-124m at full width and depth (DTensor weights and
   cache), batch 8, prompt 64, 8 greedy decode steps, against
   ``model.prefill_step``/``decode_step`` with no mesh: tokens identical,
   logits within LOGIT_TOL, whether bit-identical printed; no session is
   installed and no kernel launches.  10c: the op counts
   (``roofline.op_counts``) of one gpt2 prefill and decode step (10b's
   shapes) and one train step (phase 8's), their ``H100_SXM`` roofline
   terms beside each step's measured device time; then gpt2's weights and
   a 256-row cache placed on the card: ``tree_device_bytes`` equal to
   the caching allocator's requested bytes, and within its rounding of
   ``memory_allocated``'s growth.  10d: ``python -m
   repro_torch.launch.dryrun`` for gemma2-9b ``decode_32k`` at full depth
   on a fake 256-rank world, and the five other cells of
   tests/test_torch_dryrun_ref.py at one layer group in two more
   processes, on the host's CPU (the card hidden), beside 10a-10c: every
   process exits 0, every cell counted with no error, the decode cell's
   all-gather under its embedding table's bytes (ROADMAP C16), each
   cell's time printed.
11. Print the kernels line (with phase 6's and phase 10a's launch counts),
   then the result line.  Every phase prints its wall time.

Tolerances (max |kernel - plain| over max |plain|, per case): float32
1e-5 (f32 accumulation order); bfloat16 2^-7 for the GEMMs, grouped and
conv included (one bf16 ulp of the final cast), and 2^-6 for attention
(one ulp plus the f32 softmax order); server logits 5e-2 (bf16
activations through 2 to 42 layers, two attention lowerings); float32
scheduler tokens exactly equal to serial generate()'s.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
H100_HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
H100_PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, same
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6}
LOGIT_TOL = 5e-2
ARCHS = ("paper-gpt2-124m", "granite-moe-1b-a400m")
GEMMA2 = "gemma2-9b"
DENSE_2L = ("h2o-danube-3-4b", "phi4-mini-3.8b", "starcoder2-15b")
SCHED_ROWS = 8
LONG_PROMPT = 8300  # a kv bucket past twice gemma2's window of 4096
# ResNet-50 (He et al. 2016, Table 1): the first 3x3 conv of conv2_x on its
# 56x56 map and the strided 3x3 conv that opens conv3_x, as VALID convs on
# the padded input: (name, h = w, cin, cout, stride).
RESNET_CONVS = (("conv2_x", 58, 64, 64, 1), ("conv3_x", 57, 128, 128, 2))
CONV_BATCHES = (1, 3, 8)
# Phase 8: the training launcher's defaults (src/repro_torch/launch/
# train.py) on paper-gpt2-124m, a failure before step 30, and the margin
# by which the mean of the last 5 losses must fall below the first 5's
# (predicted in PERF.md §6).
TRAIN_ARCH = "paper-gpt2-124m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 128, 50, 20
TRAIN_FAIL_AT = 30
TRAIN_LR = 3e-4
# The launcher's stream over gpt2's whole vocabulary is not learnable in
# 50 steps (each bigram is seen about once), so the falling loss is held
# on the same stream's tokens restricted to the first LEARN_VOCAB ids.
LEARN_VOCAB = 512
LOSS_MARGIN = 3.0  # nats, on the LEARN_VOCAB stream
DIVERGED = 1.0  # a loss past ln(vocab) + 1 nat counts as diverged
BF16_LOSS_TOL = 1e-2  # one bf16 step's loss vs float32's, relative
GRANITE_TRAIN = ("granite-moe-1b-a400m", 4, 5)  # arch, layers, steps


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def rel_err(out: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        return float("inf"), float("inf")
    err = (o - r).abs().max().item()
    return err, err / max(r.abs().max().item(), 1e-6)


def device_ms(fn, iters: int = 50, warmup: int = 5, tries: int = 3) -> float:
    """Device time of one call of ``fn``: the summed GPU activity (kernels
    and copies) that torch.profiler records over ``iters`` calls, divided
    by ``iters``.  Host time between launches is excluded, so a small
    kernel is not timed by its Python wrapper.  A trace with no device
    activity is taken again, up to ``tries`` traces: one such trace came
    back for calls that had just run on the card (and did in the next
    process).  No device activity in every trace means nothing ran on the
    card, and fails the run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(
            e.self_device_time_total for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
        )
        if total_us > 0:
            return total_us / iters / 1e3
        print(f"torch.profiler recorded no device activity (trace {attempt} "
              f"of {tries})", file=sys.stderr)
    fail(f"torch.profiler recorded no device activity for a timed call in "
         f"{tries} traces")


def timed(row: dict, **fns) -> dict:
    """Fill ``row`` with the device time of each named callable."""
    for key, fn in fns.items():
        row[key] = device_ms(fn)
    return row


def check(name: str, out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """Max |out - ref|; fails the run when the error relative to
    max |ref| is above ``tol``."""
    err, rel = rel_err(out, ref)
    print(f"{name}: max_abs_err={err:.3g} rel={rel:.3g} (tolerance {tol:.3g})")
    if not rel <= tol:
        fail(f"{name} disagrees with its plain version: {rel}")
    return err


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_PEAK[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def phase_kernels(dev, kernels, errs: dict) -> None:
    from repro_torch.kernels.attention import (
        flash_attention,
        flash_attention_plain,
        flash_decode_split_plain,
    )
    from repro_torch.kernels.gemm import vortex_gemm, vortex_gemm_plain
    from repro_torch.kernels.grouped_gemm import (
        vortex_grouped_gemm,
        vortex_grouped_gemm_plain,
    )

    g = torch.Generator().manual_seed(0)

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    gemm_cases = [
        # (M, N, K, m_true, block_m, block_n, block_k)
        (100, 96, 80, 77, 64, 64, 32),
        (256, 768, 768, 200, 128, 128, 64),
        (33, 50, 70, 33, 16, 32, 16),
        (5, 3072, 768, 3, 64, 256, 128),
        (33, 50, 70, 33, 64, 8, 16),             # ragged K and N
        (130, 1024, 64, 129, 64, 512, 16),       # the largest accumulator
        (25088, 64, 576, 25000, 512, 32, 64),    # conv2_x's GEMM at b = 8
        (200, 512, 1024, 150, 64, 8, 64),        # granite's w_in widths
        (200, 1024, 512, 77, 64, 8, 64),         # granite's w_out widths
        (150, 40, 200, 130, 64, 8, 48),          # a k-step off a power of 2
        (300, 16, 96, 250, 192, 16, 32),         # three warpgroups
    ]
    attn_cases = {
        # (b, hq, hkv, sq, skv, d, bq, bk, causal, window, softcap, kv, off)
        "causal": (2, 12, 12, 100, 100, 64, 64, 32, True, None, None, 90, 0),
        "noncausal_kv0": (2, 4, 4, 70, 80, 16, 16, 16, False, None, None,
                          [80, 0], 0),
        "window_gqa": (2, 6, 2, 64, 64, 64, 64, 64, True, 8, None, 64, 0),
        "softcap": (1, 4, 4, 64, 64, 64, 128, 16, True, None, 5.0, 50, 0),
        "decode_offset": (3, 12, 12, 1, 256, 64, 1, 64, False, None, None,
                          [100, 0, 256], [99, -1, 255]),
        # granite-moe-1b-a400m's heads: 16 query heads over 8 kv heads of 64.
        "gqa_16_8": (2, 16, 8, 64, 64, 64, 64, 64, True, None, None, 50, 0),
        "decode_gqa_16_8": (4, 16, 8, 1, 256, 64, 1, 64, False, None, None,
                            [71, 0, 256, 1], [70, -1, 255, 0]),
        # The wgmma prefill kernel's shapes: several warpgroups (block_q 128,
        # 256) and rounds (1024 at d = 16), q rows past sq inside the block,
        # block_k 16 to 512, d = 16 and 128, per-row kv_len with a 0.
        "bq128_bk128": (2, 8, 8, 200, 256, 64, 128, 128, True, None, None,
                        190, 0),
        "bq256_rows_past_sq": (1, 4, 4, 100, 100, 64, 256, 32, True, None,
                               None, 100, 0),
        "bk256_gqa": (2, 4, 2, 256, 256, 64, 64, 256, False, None, None,
                      [230, 0], 0),
        "d16_bq1024_bk16": (1, 2, 2, 300, 300, 16, 1024, 16, True, None, None,
                            290, 0),
        "d16_bk512": (2, 4, 4, 70, 80, 16, 64, 512, False, None, None,
                      [80, 0], 0),
        "d128": (1, 4, 2, 200, 200, 128, 128, 64, True, None, None, 180, 0),
        # The split-kv decode kernel across many splits, d = 128 and 16.
        "decode_long_d128": (1, 8, 2, 1, 4096, 128, 1, 128, False, None,
                             None, 3000, 2999),
        "decode_window_d16": (2, 8, 2, 1, 300, 16, 1, 16, False, 40, 3.0,
                              [290, 17], [289, 16]),
        # The dense family: h2o-danube3's head_dim 120 (ROADMAP C3: wgmma
        # with Q/K padded to k16 and an n8 tail in P V) over GQA groups of
        # 4 and 12; gemma2's 256 with its window and softcap (group 2);
        # phi4-mini's group of 3.  Decode rows whose kv_len differ and
        # cross the window.
        "d120_gqa4_window": (2, 32, 8, 130, 130, 120, 128, 64, True, 64,
                             None, [130, 77], 0),
        "d120_gqa12": (1, 48, 4, 100, 100, 120, 64, 64, True, None, None,
                       100, 0),
        "d256_window_softcap": (1, 16, 8, 200, 200, 256, 64, 32, True, 50,
                                50.0, 200, 0),
        "gqa3_d128": (2, 24, 8, 100, 100, 128, 128, 64, True, None, None,
                      [100, 37], 0),
        "gqa12_d128": (1, 48, 4, 100, 100, 128, 64, 64, True, None, None,
                       100, 0),
        "decode_d256_window_softcap": (3, 16, 8, 1, 700, 256, 1, 32, False,
                                       100, 50.0, [700, 5, 333],
                                       [699, 4, 332]),
        "decode_d120_gqa4_window": (3, 32, 8, 1, 700, 120, 1, 64, False, 100,
                                    None, [700, 5, 333], [699, 4, 332]),
        "decode_gqa3_d128": (2, 24, 8, 1, 300, 128, 1, 64, False, None, None,
                             [300, 17], [299, 16]),
        "decode_gqa12_d120": (2, 48, 4, 1, 300, 120, 1, 64, False, 100, None,
                              [300, 17], [299, 16]),
    }
    # (G, E, C, K, N, counts, block_m, block_n, block_k): r = G/E of 1, 4
    # and 8; counts of 0, partial and C; K/N tails; the last at granite's
    # expert widths (K = 1024, N = 512), 8 sequences of decode routing.
    dec_counts = [0] * 256
    route_g = torch.Generator().manual_seed(5)
    for seq in range(8):
        for e in torch.randperm(32, generator=route_g)[:8].tolist():
            dec_counts[e * 8 + seq] = 1  # expert-major: group = e * r + seq
    pre_counts = routed_counts(route_g, 8, 16, 32, 8, 64)
    grouped_cases = [
        (4, 4, 20, 70, 50, [0, 7, 20, 20], 16, 32, 16),
        (8, 2, 33, 64, 96, [33, 0, 1, 32, 5, 33, 0, 17], 64, 64, 32),
        (256, 32, 1, 1024, 512, dec_counts, 64, 128, 64),
        (4, 4, 20, 70, 50, [0, 7, 20, 20], 64, 8, 16),  # ragged K and N
        # counts of 0, 1, partial (inside the first and second atom) and C
        (8, 2, 70, 64, 96, [70, 0, 1, 33, 5, 17, 0, 69], 64, 32, 32),
        (256, 32, 1, 1024, 512, dec_counts, 64, 8, 64),   # granite decode
        (256, 32, 64, 1024, 512, pre_counts, 64, 8, 64),  # granite prefill
        (256, 32, 64, 512, 1024, pre_counts, 64, 8, 64),  # ... its w_out
    ]

    def backends(bm, bn, bk):
        tc = bm % 64 == 0 and bn % 8 == 0 and bk % 16 == 0
        return ("cuda_core", "tensor_core") if tc else ("cuda_core",)

    def attn_backends(form, bq, bk, d):
        tc = form == "decode" or (
            bq % 64 == 0 and bk % 16 == 0 and d % 8 == 0 and d <= 256)
        return ("cuda_core", "tensor_core") if tc else ("cuda_core",)

    def took(name, backend, dtype, n0):
        """Fails unless the last launch of ``name`` took the path that its
        backend and dtype fix before the launch."""
        path = "tensor_core" if (backend, dtype) == (
            "tensor_core", torch.bfloat16) else "cuda_core"
        n = kernels.launch_counts()
        if n[f"{name}.{path}"] - n0[f"{name}.{path}"] != 1 \
                or n[name] - n0[name] != 1:
            fail(f"{name} {backend} {dtype}: the launch did not take the "
                 f"{path} path")

    for dtype in (torch.float32, torch.bfloat16):
        for M, N, K, mt, bm, bn, bk in gemm_cases:
            a, b = rnd(M, K, dtype=dtype), rnd(K, N, dtype=dtype)
            a[mt:] = float("nan")
            for backend in backends(bm, bn, bk):
                n0 = kernels.launch_counts()
                out = vortex_gemm(a, b, mt, block_m=bm, block_n=bn,
                                  block_k=bk, backend=backend)
                took("vortex_gemm", backend, dtype, n0)
                err = check(
                    f"vortex_gemm {dtype} {backend} M={M} N={N} K={K} "
                    f"m_true={mt} blocks=({bm},{bn},{bk})",
                    out, vortex_gemm_plain(a, b, mt), TOL[dtype])
                if not (out[mt:] == 0).all():
                    fail(f"vortex_gemm {backend}: rows past m_true {mt} are "
                         "not exactly zero")
                errs["vortex_gemm"] = max(errs["vortex_gemm"], err)
        for name, c in attn_cases.items():
            b_, hq, hkv, sq, skv, d, bq, bk, causal, window, softcap, kv, off = c
            q = rnd(b_, hq, sq, d, dtype=dtype) * 2  # peaked softmax rows
            k = rnd(b_, hkv, skv, d, dtype=dtype)
            v = rnd(b_, hkv, skv, d, dtype=dtype)
            lens = [kv] * b_ if isinstance(kv, int) else kv
            for i, n in enumerate(lens):
                k[i, :, n:] = float("nan")  # the staging buffer's tail
                v[i, :, n:] = float("nan")
            if isinstance(kv, int):
                kv_a, off_a = kv, off
            else:
                kv_a = torch.tensor(kv, dtype=torch.int32)
                off_a = torch.tensor(off, dtype=torch.int32) \
                    if isinstance(off, list) else off
            ref = flash_attention_plain(
                q, k, v, kv_a, off_a, causal=causal, window=window,
                softcap=softcap,
            )
            form = "decode" if sq == 1 else "prefill"
            for backend in attn_backends(form, bq, bk, d):
                path = ("decode.split_kv" if form == "decode" else
                        "prefill.tensor_core" if (backend, dtype) == (
                            "tensor_core", torch.bfloat16) else
                        "prefill.cuda_core")
                # Decode twice: the split-kv tickets must be reset.
                for _ in range(2 if form == "decode" else 1):
                    n0 = kernels.launch_counts()
                    out = flash_attention(
                        q, k, v, kv_a, off_a, block_q=bq, block_k=bk,
                        backend=backend, causal=causal, window=window,
                        softcap=softcap,
                    )
                    n = kernels.launch_counts()
                    key = f"flash_attention_{form}"
                    if n[f"flash_attention_{path}"] - \
                            n0[f"flash_attention_{path}"] != 1 \
                            or n[key] - n0[key] != 1:
                        fail(f"flash_attention {name} {backend} {dtype}: the "
                             f"launch did not take the {path} path")
                    err = check(f"flash_attention {name} {dtype} {backend} "
                                f"{path}", out, ref, ATTN_TOL[dtype])
                    if form == "decode":
                        check(f"flash_attention {name} {dtype} {backend} "
                              "against the split-kv plain version", out,
                              flash_decode_split_plain(
                                  q, k, v, kv_a, off_a, bk, causal=causal,
                                  window=window, softcap=softcap),
                              ATTN_TOL[dtype])
                    for i, n_ in enumerate(lens):
                        if n_ == 0 and not (out[i] == 0).all():
                            fail(f"flash_attention {name}: kv_len 0 row not "
                                 "zero")
                    errs[key] = max(errs[key], err)
        for G, E, C, K, N, counts, bm, bn, bk in grouped_cases:
            x, w = rnd(G, C, K, dtype=dtype), rnd(E, K, N, dtype=dtype)
            for i, n in enumerate(counts):
                x[i, n:] = float("nan")  # routing pad past each count
            cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
            ref = vortex_grouped_gemm_plain(x, w, cnt)
            for backend in backends(bm, bn, bk):
                n0 = kernels.launch_counts()
                out = vortex_grouped_gemm(x, w, cnt, block_m=bm, block_n=bn,
                                          block_k=bk, backend=backend)
                took("vortex_grouped_gemm", backend, dtype, n0)
                err = check(
                    f"vortex_grouped_gemm {dtype} {backend} G={G} E={E} C={C} "
                    f"K={K} N={N} blocks=({bm},{bn},{bk})",
                    out, ref, TOL[dtype])
                for i, n in enumerate(counts):
                    if not (out[i, n:] == 0).all():
                        fail(f"vortex_grouped_gemm {backend}: group {i} rows "
                             f"past its count {n} are not exactly zero")
                errs["vortex_grouped_gemm"] = max(
                    errs["vortex_grouped_gemm"], err)
    torch.cuda.synchronize()


def phase_window_gather(dev, kernels, errs: dict) -> None:
    """The model's decode attention (``_decode_attend``) at gemma2's shape
    (16 q over 8 kv heads of 256, window 4096, softcap 50) over a cache of
    2 x 4096 + 512 rows, three rows at positions 3000, 6000 and 8703: past
    twice the window, each row gathers its own window (starts 0, 1905 and
    4608) and dispatches one split-kv launch with its rebased kv_len.  Held
    against the same call's inline math (no engine installed), which masks
    the whole cache by position."""
    from repro_torch import vortex
    from repro_torch.models.layers import _decode_attend

    g = torch.Generator().manual_seed(11)
    dt, H, hkv, d, W, cap = torch.bfloat16, 16, 8, 256, 4096, 50.0
    S = 2 * W + 512
    pos = torch.tensor([3000, 6000, S - 1], dtype=torch.int32, device=dev)
    q = torch.randn(3, H, 1, d, generator=g).to(dev, dt) * 2
    kc, vc = (torch.randn(3, hkv, S, d, generator=g).to(dev, dt)
              for _ in range(2))
    eng = vortex.Engine()  # the defaults: H100 lattice, CUDA kernels, card
    n0 = kernels.launch_counts()
    with eng.use():
        out = _decode_attend(q, kc, vc, pos, W, cap, d ** -0.5)
    n = kernels.launch_counts()
    ran = {key: n[key] - n0[key] for key in n if n[key] != n0[key]}
    if ran != {"flash_attention_decode": 1,
               "flash_attention_decode.split_kv": 1}:
        fail(f"window-slice decode: launches {ran}, not one split-kv launch")
    err = check(f"decode attention through the per-row window slice (cache "
                f"{S}, rows at {pos.tolist()}, window {W}, softcap {cap})",
                out, _decode_attend(q, kc, vc, pos, W, cap, d ** -0.5),
                ATTN_TOL[dt])
    errs["flash_attention_decode"] = max(errs["flash_attention_decode"], err)
    del q, kc, vc
    free_cuda()


def all_tensor_core(counts: dict, where: str) -> None:
    """Fails unless every launch of the GEMM, the grouped GEMM and prefill
    attention in ``counts`` (all bf16 on the main paths) took the
    tensor-core path, and every decode-attention launch the split-kv one."""
    for name, path in (("vortex_gemm", "tensor_core"),
                       ("vortex_grouped_gemm", "tensor_core"),
                       ("flash_attention_prefill", "tensor_core"),
                       ("flash_attention_decode", "split_kv")):
        if counts[f"{name}.{path}"] != counts[name]:
            fail(f"{where}: {counts[name] - counts[f'{name}.{path}']} of "
                 f"{counts[name]} bf16 {name} launches did not take the "
                 f"{path} path")
    fold_feeds(counts, where)


# The tensor-core GEMM's sub-counters (kernels/gemm.py LAUNCHES): which of
# its two kernels ran, and the TMA launches made as 2-CTA clusters.
TC_FEEDS = ("vortex_gemm.tensor_core.tma", "vortex_gemm.tensor_core.cp_async",
            "vortex_gemm.tensor_core.multicast")


def fold_feeds(moved: dict, where: str) -> dict:
    """``moved`` (launch counts or their deltas) without the tensor-core
    GEMM's sub-counters, after failing unless its TMA and cp.async launches
    add up to its tensor-core launches (and the multicast ones to no more
    than the TMA ones)."""
    tc = moved.get("vortex_gemm.tensor_core", 0)
    tma, cp, mc = (moved.get(k, 0) for k in TC_FEEDS)
    if tma + cp != tc or mc > tma:
        fail(f"{where}: {tma} TMA ({mc} multicast) and {cp} cp.async "
             f"launches of the tensor-core GEMM for {tc} tensor-core ones")
    return {k: n for k, n in moved.items() if k not in TC_FEEDS}


# ---------------------------------------------------------------------------
# Phase 3: main path 1 — vortex.ops.gemm
# ---------------------------------------------------------------------------


def pool_allocs(kern) -> int:
    """Staging-buffer sets the engine kernel's entries ever made."""
    return sum(e.pool.allocs for e in kern._exec_cache.values()
               if e.pool is not None)


def folded_calls(delta: dict, staged: int, kerns, operands: int,
                 unstages: bool, where: str) -> None:
    """Fails unless every unaligned call in ``delta`` (a DispatchStats
    difference) launched on its own operands: no staging launch, no copy,
    ``operands`` folded stages (and one folded unstage) a call, and no
    staging set ever made for the engine kernels ``kerns``."""
    n = delta["unaligned_calls"]
    want = {"stage_copies": 0, "unstage_copies": 0,
            "folded_stages": operands * n,
            "folded_unstages": n if unstages else 0}
    got = {k: delta[k] for k in want}
    sets = sum(pool_allocs(k) + len(k.staging_sets()) for k in kerns)
    if not n or staged or got != want or sets:
        fail(f"{where}: {n} unaligned calls made {staged} staging launches "
             f"and {sets} pool sets, counters {got}; expected {want}, none "
             f"and none")


def phase_gemm(dev, kernels) -> dict:
    from repro_torch import vortex
    from repro_torch.kernels.gemm import vortex_gemm_plain

    eng = vortex.Engine()  # the defaults: H100 lattice, CUDA kernels, card
    d = 768
    g = torch.Generator().manual_seed(1)
    b = torch.randn(d, d, generator=g).to(dev, torch.bfloat16)
    op = vortex.compile("gemm", engine=eng, M=None, N=d, K=d)
    bucket = op.bucket(100)
    ms = [1, bucket - 1, bucket, bucket + 1, 97]
    inputs = [torch.randn(m, d, generator=g).to(dev, torch.bfloat16) for m in ms]
    kernels.reset_launch_counts()
    before = op.stats()["dispatch"]
    outs = []
    with vortex.use(eng):
        for a in inputs:
            n0 = kernels.launch_counts()["vortex_gemm"]
            outs.append(vortex.ops.gemm(a, b))
            if kernels.launch_counts()["vortex_gemm"] - n0 != 1:
                fail("vortex.ops.gemm did not make exactly one kernel launch")
    launches = kernels.launch_counts()["vortex_gemm"]
    staged = kernels.launch_counts()["stage_copy"]
    torch.cuda.synchronize()
    after = op.stats()["dispatch"]
    delta = {k: after[k] - before[k] for k in after}
    unaligned = delta["unaligned_calls"]
    print(f"main path gemm: M={ms} bucket={bucket} kernel_launches={launches} "
          f"engine_launches={delta['launches']} "
          f"padded_calls={delta['padded_calls']} "
          f"stage_copies={delta['stage_copies']} "
          f"folded_stages={delta['folded_stages']} "
          f"folded_unstages={delta['folded_unstages']} "
          f"stage_launches={staged} for {unaligned} unaligned calls "
          f"(pool sets made: {pool_allocs(op.kernel)})")
    if launches != len(ms) or delta["padded_calls"] != 0:
        fail("gemm main path: expected one launch per call and 0 padded calls")
    folded_calls(delta, staged, [op.kernel], 1, True, "gemm main path")
    all_tensor_core(kernels.launch_counts(), "gemm main path")
    worst = 0.0
    for a, out in zip(inputs, outs):
        if out.shape != (a.shape[0], d):
            fail(f"gemm main path: output shape {tuple(out.shape)}")
        _, rel = rel_err(out, vortex_gemm_plain(a, b))
        worst = max(worst, rel)
    if not worst <= TOL[torch.bfloat16]:
        fail(f"gemm main path disagrees with the plain version: {worst}")
    sel = op.select(bucket)
    return {"launches": launches, "M": bucket, "N": d, "K": d,
            "blocks": sel.strategy.l1, "backend": sel.strategy.backend}


# ---------------------------------------------------------------------------
# Phase 3b: main path 1b — vortex.ops.conv2d at ResNet-50 shapes
# ---------------------------------------------------------------------------


def phase_conv(dev, kernels) -> dict:
    from repro_torch import vortex
    from repro_torch.kernels.conv import conv_weight_matrix, im2col
    from repro_torch.kernels.gemm import vortex_gemm_plain

    eng = vortex.Engine()  # the defaults: H100 lattice, CUDA kernels, card
    g = torch.Generator().manual_seed(3)
    weights = {
        name: torch.randn(3, 3, cin, cout, generator=g).mul_(
            (9 * cin) ** -0.5).to(dev, torch.bfloat16)
        for name, _, cin, cout, _ in RESNET_CONVS
    }
    inputs = [
        (name, stride, torch.randn(b, hw, hw, cin, generator=g)
         .to(dev, torch.bfloat16))
        for b in CONV_BATCHES for name, hw, cin, _, stride in RESNET_CONVS
    ]
    kernels.reset_launch_counts()
    outs = []
    with vortex.use(eng):
        for name, stride, x in inputs:
            n0 = kernels.launch_counts()["vortex_gemm"]
            outs.append(vortex.ops.conv2d(x, weights[name], stride=stride))
            if kernels.launch_counts()["vortex_gemm"] - n0 != 1:
                fail("vortex.ops.conv2d did not make exactly one GEMM launch")
    launches = kernels.launch_counts()["vortex_gemm"]
    staged = kernels.launch_counts()["stage_copy"]
    torch.cuda.synchronize()
    st = eng.stats()["conv2d"]
    print(f"main path conv2d: calls={len(inputs)} kernel_launches={launches} "
          f"engine_launches={st['launches']} padded_calls={st['padded_calls']} "
          f"stage_copies={st['stage_copies']} "
          f"folded_stages={st['folded_stages']} "
          f"folded_unstages={st['folded_unstages']} stage_launches={staged} "
          f"for {st['unaligned_calls']} unaligned calls")
    if launches != len(inputs) or st["padded_calls"] != 0:
        fail("conv2d main path: expected one launch per call and 0 padded")
    folded_calls(st, staged, eng.kernels().values(), 1, True,
                 "conv2d main path")
    all_tensor_core(kernels.launch_counts(), "conv2d main path")
    for (name, stride, x), out in zip(inputs, outs):
        w = weights[name]
        cols, (b, ho, wo) = im2col(x, 3, 3, stride)
        if out.shape != (b, ho, wo, w.shape[3]):
            fail(f"conv2d main path: output shape {tuple(out.shape)}")
        ref = vortex_gemm_plain(cols, conv_weight_matrix(w))
        check(f"vortex.ops.conv2d {name} b={b} M={b * ho * wo}",
              out.reshape(ref.shape), ref, TOL[torch.bfloat16])
    name, hw, cin, cout, stride = RESNET_CONVS[0]
    b = max(CONV_BATCHES)
    m = b * ((hw - 3) // stride + 1) ** 2
    x8 = next(x for n, _, x in inputs if n == name and x.shape[0] == b)
    sel = eng.op_kernel("conv2d", (x8, weights[name]),
                        {"stride": stride}).select(m)
    return {"launches": launches, "name": name, "b": b, "hw": hw,
            "cin": cin, "cout": cout, "stride": stride, "M": m,
            "blocks": sel.strategy.l1, "backend": sel.strategy.backend}


# ---------------------------------------------------------------------------
# Phase 3c: every kernel path folded at a true extent one row off its bucket
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
# (label, kind, backend, dtype, the path counter the launch must move).
FOLD_CASES = (
    ("gemm tensor_core bf16", "gemm", "tensor_core", BF16,
     "vortex_gemm.tensor_core"),
    ("gemm cuda_core bf16", "gemm", "cuda_core", BF16,
     "vortex_gemm.cuda_core"),
    ("gemm tensor_core f32", "gemm", "tensor_core", F32,
     "vortex_gemm.cuda_core"),
    ("gemm cuda_core f32", "gemm", "cuda_core", F32, "vortex_gemm.cuda_core"),
    ("grouped tensor_core bf16", "grouped_gemm", "tensor_core", BF16,
     "vortex_grouped_gemm.tensor_core"),
    ("grouped cuda_core bf16", "grouped_gemm", "cuda_core", BF16,
     "vortex_grouped_gemm.cuda_core"),
    ("prefill tensor_core bf16", "attention", "tensor_core", BF16,
     "flash_attention_prefill.tensor_core"),
    ("prefill cuda_core bf16", "attention", "cuda_core", BF16,
     "flash_attention_prefill.cuda_core"),
    ("decode per-row kv_len bf16", "decode_attention", "tensor_core", BF16,
     "flash_attention_decode.split_kv"),
    ("decode kv_len bf16", "decode_attention", "cuda_core", BF16,
     "flash_attention_decode.split_kv"),
    ("conv2d tensor_core bf16", "conv2d", "tensor_core", BF16,
     "vortex_gemm.tensor_core"),
)
# Widths: (full = the main paths', small = the memcheck run's).  gemm N = K;
# grouped (G, E, K, N) at granite's expert widths; attention (b, heads,
# head_dim) at paper-gpt2's; conv (cin, cout) at ResNet-50's conv2_x.
FOLD_WIDTHS = {
    False: {"gemm": 768, "grouped": (64, 32, 1024, 512),
            "attention": (2, 12, 64), "decode": (8, 12, 64),
            "conv": (64, 64), "extent": 100},
    True: {"gemm": 64, "grouped": (4, 2, 64, 32), "attention": (1, 2, 64),
           "decode": (2, 2, 64), "conv": (16, 16), "extent": 40},
}


def poisoned(shape, dtype, dev, g, tail: int) -> torch.Tensor:
    """Seeded values in a tensor whose allocation runs on ``tail``
    elements past its end in NaN: a kernel that reads past the operand's
    last row reads NaN."""
    n = int(np.prod(shape))
    buf = torch.full((n + tail,), float("nan"), dtype=dtype, device=dev)
    buf[:n] = torch.randn(n, generator=g).to(dev, dtype)
    return buf[:n].view(shape)


def fold_args(kind: str, label: str, m: int, dtype, dev, widths: dict, g):
    """The call args of one phase-3c case at dynamic extent ``m``, and its
    params; each dynamic operand is followed in its allocation by
    ``widths["tail"]`` NaN elements."""
    def rnd(*shape):
        return poisoned(shape, dtype, dev, g, widths["tail"])

    if kind == "gemm":
        d = widths["gemm"]
        return (rnd(m, d), rnd(d, d)), {}
    if kind == "grouped_gemm":
        G, E, K, N = widths["grouped"]
        x = rnd(G, m, K)
        counts = torch.randint(0, m + 1, (G,), generator=g)
        counts[0], counts[1], counts[-1] = 0, m, m - 1
        for i, c in enumerate(counts.tolist()):
            x[i, c:] = float("nan")  # never read: past the group's count
        return (x, rnd(E, K, N), counts.to(dev, torch.int32)), {}
    if kind == "attention":
        b, h, d = widths["attention"]
        return (rnd(b, h, m, d), rnd(b, h, m, d), rnd(b, h, m, d)), \
            {"causal": True}
    if kind == "decode_attention":
        b, h, d = widths["decode"]
        if "per-row" in label:
            rows = torch.randint(1, m + 1, (b,), generator=g)
            rows[0], rows[-1] = m, 0  # the whole cache, and an empty row
            kv_len = rows.to(dev, torch.int32)
        else:
            kv_len = m - 3
        return (rnd(b, h, 1, d), rnd(b, h, m, d), rnd(b, h, m, d), kv_len), {}
    cin, cout = widths["conv"]
    # A 3x3 VALID conv over (m + 2) x 3 pixels: M = b * h' * w' = m.
    return (rnd(1, m + 2, 3, cin),
            torch.randn(3, 3, cin, cout, generator=g).mul_(
                (9 * cin) ** -0.5).to(dev, dtype)), {}


def fold_extent(kern, kind, label, dtype, dev, widths, g):
    """(m, its selection, operands off their bucket): the extent nearest
    the widths' own at which an operand stands one row short of its
    bucket."""
    wl = kern.workload
    e = widths["extent"]
    for m in sorted(range(2, 4 * e), key=lambda m: (abs(m - e), m)):
        sel = kern.select(m)
        args, _ = fold_args(kind, label, m, dtype, dev, widths, g)
        view = wl.stage_view(*args)
        gaps = [b - n for i, s in enumerate(wl.staged_shapes(sel, *view))
                if s is not None
                for b, n in zip(s, view[i].shape) if b != n]
        if 1 in gaps:
            return m, sel, len([x for x in gaps if x])
    fail(f"phase 3c {label}: no extent one row off its bucket")


def phase_fold(dev, kernels, small: bool = False, tail: int = 4096) -> dict:
    """Phase 3c: each kernel path of an engine dispatch at a true extent
    one row below its bucket, launched on the caller's own operands: one
    launch on the path its backend and dtype name, no staging launch, no
    pool set, ``folded_stages`` = the operands off their bucket, the
    output at the true extent, finite and bit-identical to
    ``call_padded`` (the zero-padded bucket-shaped launch).  The dynamic
    operands' allocations run on ``tail`` elements in NaN, so a read past
    an operand's last row shows.  ``small`` runs the memcheck widths
    (benchmarks_torch/fold_memcheck.py)."""
    from repro_torch import vortex

    widths = dict(FOLD_WIDTHS[small], tail=tail)
    g = torch.Generator().manual_seed(14)
    folded = {}
    for label, kind, backend, dtype, path in FOLD_CASES:
        eng = vortex.Engine(backends=(backend,))
        probe, params = fold_args(kind, label, widths["extent"], dtype, dev,
                                  widths, g)
        kern = eng.op_kernel(kind, probe, params)
        wl = kern.workload
        m, sel, off = fold_extent(kern, kind, label, dtype, dev, widths, g)
        args, params = fold_args(kind, label, m, dtype, dev, widths, g)
        eng.dispatch(kind, *args, **params)  # builds the executable
        torch.cuda.synchronize()
        n0, st0 = kernels.launch_counts(), kern.dispatch_stats.as_dict()
        out = eng.dispatch(kind, *args, **params)
        torch.cuda.synchronize()
        n1, st1 = kernels.launch_counts(), kern.dispatch_stats.as_dict()
        launched = fold_feeds({k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]},
                              f"phase 3c {label}")
        delta = {k: st1[k] - st0[k] for k in st1}
        want = {path.split(".")[0]: 1, path: 1}
        if launched != want or delta["launches"] != 1 or not off:
            fail(f"phase 3c {label}: launches {launched} (expected {want}), "
                 f"engine launches {delta['launches']}, {off} operands off "
                 f"the bucket")
        folded_calls(delta, launched.get("stage_copy", 0), [kern], off,
                     wl.unstages, f"phase 3c {label}")
        ref = kern.call_padded(*args)
        torch.cuda.synchronize()
        same = out.shape == ref.shape and torch.equal(out, ref)
        print(f"phase 3c {label}: {kind} extent {m} in bucket {sel.bucket} "
              f"tile {sel.strategy.l1} path {path}: {off} operands read at "
              f"their own extent, output {tuple(out.shape)}, bit-identical "
              f"to call_padded={same}")
        if not same or not torch.isfinite(out).all():
            fail(f"phase 3c {label}: the folded launch differs from "
                 f"call_padded or is not finite")
        folded[label] = {"bucket": sel.bucket, "extent": m, "path": path}
    return folded


# ---------------------------------------------------------------------------
# Phases 4 and 4b: main paths 2 and 3 — VortexServer on paper-gpt2-124m and
# granite-moe-1b-a400m
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def grouped_launches_by_form(kernels, server, per_form: dict):
    """Count the grouped-GEMM launches of every prefill and decode step
    the server makes (``per_form``; ``<form>_stacked`` the tensor-core
    launches whose m-tiles stack groups) and check each step's count.  A
    graphed decode step counts the launches its replay adds (the ones its
    capture recorded)."""
    real = {"prefill": server.prefill, "decode": server._decode}

    def counted(form):
        def step(*args, **kwargs):
            c0 = kernels.launch_counts()
            out = real[form](*args, **kwargs)
            c1 = kernels.launch_counts()
            n = c1["vortex_grouped_gemm"] - c0["vortex_grouped_gemm"]
            per_form[form] += n
            per_form[f"{form}_stacked"] = per_form.get(f"{form}_stacked", 0) + (
                c1["vortex_grouped_gemm.stacked"]
                - c0["vortex_grouped_gemm.stacked"])
            per_form[f"{form}_forwards"] += 1
            per_form["per_forward"].add(n)
            return out
        return step

    server.prefill, server._decode = counted("prefill"), counted("decode")
    try:
        yield
    finally:
        del server.prefill, server._decode  # the class's methods again


def routing_flips(topi_a: list, topi_b: list, b: int, s: int) -> float:
    """Share of (token, choice) assignments of the real rows whose expert
    is not among the other run's choices for that token, over all layers."""
    differ = total = 0
    for ta, tb in zip(topi_a, topi_b):
        ta, tb = ta[:b, :s], tb[:b, :s]
        same = (ta[..., :, None] == tb[..., None, :]).any(-1)
        differ += int((~same).sum())
        total += same.numel()
    return differ / max(total, 1)


def phase_serve(dev, kernels, arch: str) -> dict:
    from repro_torch.launch.serve import Request, VortexServer
    from repro_torch.models.model import decode_step, prefill_step
    from repro_torch.models.registry import get_config

    cfg = get_config(arch)
    moe = cfg.moe is not None
    t0 = time.perf_counter()
    server = VortexServer(cfg, max_cache=256, seed=0)
    print(f"server: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim} "
          f"d_ff={cfg.d_ff} moe={cfg.moe} "
          f"vocab={cfg.vocab} dtype={cfg.dtype} "
          f"hardware={server.engine.config.hardware} "
          f"impl={server.engine.config.impl} init_s={time.perf_counter() - t0:.2f}")
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(8):
        b = int(rng.integers(1, 9)) if i else 8
        s = int(rng.integers(4, 65)) if i else 64
        toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)
        reqs.append(Request(tokens=toks, max_new=8))
    server.warmup(max_batch=8, m_max=64, max_new=8)
    if server.graphs is None:
        fail("serve: the server runs the eager decode step on the card")
    captured = dict(server.stats)

    per_form = {"prefill": 0, "decode": 0, "prefill_forwards": 0,
                "decode_forwards": 0, "per_forward": set()}
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with grouped_launches_by_form(kernels, server, per_form):
        outs = [server.generate(r) for r in reqs]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    graphs = {k: server.stats[k] - captured[k]
              for k in ("decode_graph_captures", "decode_graph_replays")}
    prefill_graphs = {k: server.stats[k] - captured[k]
                      for k in ("prefill_graph_captures",
                                "prefill_graph_replays")}

    tokens = sum(o.size for o in outs)
    steps = sum(r.max_new - 1 for r in reqs)
    st = server.engine_dispatch_stats()
    ds = st["decode_step"]
    print(f"main path serve {cfg.name}: requests={len(reqs)} "
          f"shapes={[r.tokens.shape for r in reqs]} tokens={tokens} "
          f"decode_steps={ds['launches']} wall_s={wall:.3f} "
          f"kernel_launches={counts}")
    print(f"engine: attention={st['attention']} "
          f"decode_attention={st['decode_attention']} kv_pool={st['kv_pool']}")
    for r, o in zip(reqs, outs):
        if o.shape != (r.tokens.shape[0], r.max_new):
            fail(f"serve: output shape {o.shape}")
        if not ((o >= 0) & (o < cfg.vocab)).all():
            fail("serve: token outside the vocabulary")
    if ds["launches"] != steps or ds["padded_calls"] != 0:
        fail(f"serve: {ds['launches']} decode steps for {steps} tokens")
    print(f"serve {cfg.name}: warmup captured "
          f"{captured['decode_graph_captures']} decode graphs; the requests "
          f"made {graphs['decode_graph_replays']} replays and "
          f"{graphs['decode_graph_captures']} captures for {steps} steps")
    if graphs != {"decode_graph_captures": 0, "decode_graph_replays": steps}:
        fail(f"serve: expected one replay of a warmed graph per decode step, "
             f"got {graphs} for {steps} steps")
    print(f"serve {cfg.name}: warmup captured "
          f"{captured['prefill_graph_captures']} prefill graphs; the requests "
          f"made {prefill_graphs['prefill_graph_replays']} replays and "
          f"{prefill_graphs['prefill_graph_captures']} captures for "
          f"{len(reqs)} prefills")
    if prefill_graphs != {"prefill_graph_captures": 0,
                          "prefill_graph_replays": len(reqs)}:
        fail(f"serve: expected one replay of a warmed prefill graph per "
             f"request, got {prefill_graphs}")
    if counts["flash_attention_decode"] != cfg.n_layers * steps:
        fail("serve: expected n_layers decode-attention launches per token")
    if counts["flash_attention_prefill"] != cfg.n_layers * len(reqs):
        fail("serve: expected n_layers prefill-attention launches per request")
    dec = st["decode_attention"]
    if dec["padded_calls"] or dec["stage_copies"] or st["attention"]["padded_calls"]:
        fail(f"serve: padded calls or stage copies on the decode path: {dec}")
    if st["kv_pool"]["leases_active"] != 0:
        fail("serve: kv pool leases leaked")
    all_tensor_core(counts, f"serve {cfg.name}")
    dropped = None
    if moe:
        per_layer = 3 * cfg.n_layers
        gg = st["grouped_gemm"]
        dropped = server.mean_dropped_frac()
        print(f"grouped_gemm: launches prefill={per_form['prefill']} "
              f"decode={per_form['decode']} stacked prefill="
              f"{per_form.get('prefill_stacked', 0)} decode="
              f"{per_form.get('decode_stacked', 0)} per forward="
              f"{sorted(per_form['per_forward'])} engine={gg} "
              f"mean dropped_frac={dropped:.6f}")
        if (per_form["prefill"] != per_layer * len(reqs)
                or per_form["decode"] != per_layer * steps
                or per_form["per_forward"] != {per_layer}
                or counts["vortex_grouped_gemm"] != per_layer * (len(reqs) + steps)):
            fail(f"serve: expected {per_layer} grouped-GEMM launches per "
                 f"forward, got {per_form}")
        if gg["padded_calls"] != 0:
            fail(f"serve: {gg['padded_calls']} padded grouped-GEMM calls")
    elif counts["vortex_grouped_gemm"]:
        fail("serve: a dense model launched the grouped GEMM")

    # One request against the same server lowered with impl="torch".
    plain = VortexServer(cfg, max_cache=256, params=server.params, impl="torch")
    r = reqs[1]
    b, s = r.tokens.shape
    bp, sp = server.batch_bucket(b), server.seq_bucket(s)
    toks = np.zeros((bp, sp), np.int64)
    toks[:b, :s] = r.tokens
    toks = torch.from_numpy(toks).to(dev)
    kvb = server.kv_bucket(max(sp, s + 1))  # room for the decode row at s
    worst = {}
    logits = {}
    topi = {}
    for name, srv in (("cuda", server), ("torch", plain)):
        with srv.engine.use():
            lp, cache, sp_stats = prefill_step(
                cfg, srv.params, toks, cache_len=kvb, last=s - 1)
            nxt = lp.argmax(-1)[:, None] if name == "cuda" else logits["next"]
            logits.setdefault("next", nxt)
            ld, _, sd_stats = decode_step(cfg, srv.params, cache, nxt, s)
        logits[name] = (lp[:b], ld[:b])
        topi[name] = (sp_stats["topi"], sd_stats["topi"])
    for i, phase in enumerate(("prefill", "decode")):
        # The vocab pad columns hold -1e30 on both sides; compare the rest.
        err, rel = rel_err(logits["cuda"][i][:, :cfg.vocab],
                           logits["torch"][i][:, :cfg.vocab])
        worst[phase] = rel
        print(f"serve {cfg.name} {phase} logits vs impl=torch: "
              f"max_abs_err={err:.4g} rel={rel:.4g} (tolerance {LOGIT_TOL})")
        if not rel <= LOGIT_TOL:
            fail(f"serve {phase} logits disagree with impl='torch': {rel}")
    flips = None
    if moe:
        flips = [routing_flips(topi["cuda"][i], topi["torch"][i], b,
                               s if i == 0 else 1) for i in (0, 1)]
        print(f"routing: share of (token, choice) assignments whose expert "
              f"differs between impl=cuda and impl=torch: prefill="
              f"{flips[0]:.6g} decode={flips[1]:.6g} "
              f"(b={b}, s={s}, {cfg.n_layers} layers)")
    del plain
    torch.cuda.synchronize()

    # The shapes the main path gave the kernels: the largest request's
    # prefill, and its last decode step (kv_len = pos + 1 rows of the kv
    # bucket the cache had grown to by then).
    big = max(reqs, key=lambda q: q.tokens.size)
    bp = server.batch_bucket(big.tokens.shape[0])
    sp = server.seq_bucket(big.tokens.shape[1])
    kv_len = big.tokens.shape[1] + big.max_new - 1
    kvb = server.kv_bucket(sp)
    if kv_len > kvb:
        kvb = server._grown_kv_bucket(kvb, kv_len)
    return {
        "counts": counts, "cfg": cfg, "server": server, "bp": bp, "sp": sp,
        "kvb": kvb, "kv_len": kv_len, "logit_rel": worst,
        "tokens": tokens, "wall_s": wall, "per_form": per_form,
        "dropped_frac": dropped, "routing_flips": flips,
        "reqs": reqs, "outs": outs,
    }


def phase_graphs(info: dict) -> dict:
    """Phase 4g, serial form: phase 4's (or 4b's) server replays its
    captured decode graphs, step by step, beside an eager server
    (``graphs=False``) on the same weights, from copies of the same
    prefill cache: scalar ``pos``, 3 rows, through a growth into the next
    kv bucket.  Every step's logits (and an MoE model's ``dropped_frac``)
    must be bit-identical and the tokens identical; then ``generate()``
    gives the same tokens on both servers."""
    from repro_torch.launch.serve import Request, VortexServer

    srv, cfg = info["server"], info["cfg"]
    eager = VortexServer(cfg, max_cache=srv.max_cache, params=srv.params,
                         graphs=False)
    dropped: dict[str, list] = {"graphed": [], "eager": []}
    for name, x in (("graphed", srv), ("eager", eager)):
        def note(d, name=name, real=x._note_moe):
            dropped[name].append(d.clone())
            real(d)
        x._note_moe = note
    rng = np.random.default_rng(7)
    b, s = 3, 60
    kvb = srv.kv_bucket(srv.seq_bucket(s))
    n = kvb - s + 4  # the cache grows into the next kv bucket
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int64)
    g0 = dict(srv.stats)
    tok, cache, kvb = srv.prefill(toks)
    copy = {k: {m: leaf.clone() for m, leaf in e.items()}
            for k, e in cache.items()}
    eager.adopt_cache(copy)
    dropped = {"graphed": [], "eager": []}  # the decode steps only
    t, pos, kvbs = tok[:, None], s - 1, [kvb]
    try:
        for _ in range(n - 1):
            pos += 1
            if pos + 1 > kvb:
                kvb = srv._grown_kv_bucket(kvb, pos + 1)
                cache = srv._grow_cache(cache, kvb)
                copy = eager._grow_cache(copy, kvb)
                kvbs.append(kvb)
            got = srv._decode(cache, t, pos, srv._decode_seen)
            want = eager._decode(copy, t, pos, eager._decode_seen)
            if not torch.equal(got, want):
                fail(f"phase 4g: {cfg.name} step at pos {pos}: graphed "
                     f"logits differ from the eager step's (max |diff| "
                     f"{(got.float() - want.float()).abs().max().item()})")
            t = got.argmax(-1)[:, None]
        if not all(torch.equal(a, e) for a, e in
                   zip(dropped["graphed"], dropped["eager"])):
            fail(f"phase 4g: {cfg.name} dropped_frac differs")
    finally:
        srv.release_cache(cache)
        eager.release_cache(copy)
        del srv._note_moe  # the class's method again
    req = Request(tokens=toks, max_new=n)
    same_tokens = np.array_equal(srv.generate(req), eager.generate(req))
    graphs = {k: srv.stats[k] - g0[k]
              for k in ("decode_graph_captures", "decode_graph_replays")}
    print(f"phase 4g: {cfg.name} {n - 1} decode steps (b={b}, prompt {s}, "
          f"kv buckets {kvbs}): graph replay vs eager step logits "
          f"bit-identical, tokens identical; generate() tokens identical="
          f"{same_tokens}; {graphs}"
          + (f"; dropped_frac bit-identical over {len(dropped['graphed'])} "
             f"steps" if cfg.moe is not None else ""))
    if not same_tokens:
        fail(f"phase 4g: {cfg.name} generate() tokens differ, graphed vs "
             f"eager")
    if len(kvbs) < 2:
        fail(f"phase 4g: {cfg.name} never grew past kv bucket {kvbs}")
    del eager
    return {"steps": n - 1, "kvbs": kvbs, **graphs}


# ---------------------------------------------------------------------------
# Phase 4i: graphed "aot" prefills against eager ones
# ---------------------------------------------------------------------------

PREFILL_GRAPH_CASES = ((1, 64), (2, 100), (4, 37))  # (rows, prompt)


def phase_prefill_graphs(info: dict) -> dict:
    """Phase 4i: phase 4's (or 4b's) server replays its "aot" prefill
    graph beside an eager server (``graphs=False``) on the same weights,
    at three (batch, seq) keys: one whose prompt fills its seq bucket, one
    unaligned in s (100 in a 128-row bucket, a key warmup did not
    capture) and one of 4 rows.  The first-token logits, the MoE
    ``dropped_frac`` and every cache leaf's rows must be bit-identical."""
    from repro_torch.launch.serve import VortexServer

    srv, cfg = info["server"], info["cfg"]
    dev = srv.device
    eager = VortexServer(cfg, max_cache=srv.max_cache, params=srv.params,
                         graphs=False)
    rng = np.random.default_rng(8)
    g0 = dict(srv.stats)
    for b, s in PREFILL_GRAPH_CASES:
        bp, sp = srv.batch_bucket(b), srv.seq_bucket(s)
        kvb = srv.kv_bucket(sp)
        toks = torch.zeros((bp, sp), dtype=torch.int64)
        toks[:b, :s] = torch.from_numpy(
            rng.integers(0, cfg.vocab, (b, s)).astype(np.int64))
        n0 = dict(srv.stats)
        cache = srv.lease_cache(bp, kvb)
        try:
            got, dropped = (t.clone() for t in
                            srv._prefill_graphed(cache, toks, s - 1))
            want, want_drop, ecache = eager._prefill_eager(
                None, toks.to(dev), s - 1, kvb)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"phase 4i: {cfg.name} (b={b}, s={s}): graphed logits "
                     f"differ from the eager prefill's (max |diff| "
                     f"{(got.float() - want.float()).abs().max().item()})")
            if not torch.equal(dropped, want_drop):
                fail(f"phase 4i: {cfg.name} dropped_frac differs")
            for key, entry in cache.items():
                for name, leaf in entry.items():
                    if not torch.equal(leaf[..., :sp, :],
                                       ecache[key][name][..., :sp, :]):
                        fail(f"phase 4i: {cfg.name} (b={b}, s={s}) cache "
                             f"{key}/{name} differs")
        finally:
            srv.release_cache(cache)
        moved = {k: srv.stats[k] - n0[k] for k in
                 ("prefill_graph_captures", "prefill_graph_replays")}
        print(f"phase 4i: {cfg.name} prefill (b={b}, s={s}) at bucket "
              f"({bp}, {sp}), kv {kvb}: graph replay vs eager logits, "
              f"dropped_frac and cache bit-identical; {moved}")
    del eager
    return {k: srv.stats[k] - g0[k]
            for k in ("prefill_graph_captures", "prefill_graph_replays")}


# ---------------------------------------------------------------------------
# Phase 4h: the chained prefill (lazy bucket handles)
# ---------------------------------------------------------------------------

CHAIN_CASES = ((1, 100), (2, 100), (1, 150))  # (rows, prompt)
CHAIN_KEYS = ("stage_copies", "unstage_copies", "realize_slices",
              "forwarded")


def chain_counters(engine) -> dict:
    out = dict.fromkeys(CHAIN_KEYS, 0)
    for kind, st in engine.stats().items():
        if kind == "calibration":  # engine-level section, not a kind
            continue
        for k in CHAIN_KEYS:
            out[k] += st[k]
    return out


def chain_gemm_launches(server) -> dict:
    """Launches per chain GEMM signature (K, N) on the server's engine."""
    from repro_torch.core.workloads import GemmWorkload

    return {(k, n): server.engine.kernel_for(
        GemmWorkload(M=None, N=n, K=k)).dispatch_stats.launches
        for k, n in server._chain_gemm_sigs()}


def chain_prefill(kernels, server, aot, b: int, s: int, rng,
                  where: str) -> dict:
    """One chained prefill of a (b, s) prompt at its chain bucket, checked:
    the bucket is chain-aligned, 0 stage, unstage and realize copies,
    ``forwarded >= n_layers``, every GEMM (n_layers x projections + the
    head) and prefill-attention launch on the tensor cores and nothing
    else launched, the logits and every cache leaf bit-identical to
    ``eager=True``, and the first-token logits within LOGIT_TOL of the
    "aot" prefill's (``aot``'s eager forward at seq_bucket(s), the same
    weights)."""
    cfg = server.cfg
    bp = server.batch_bucket(b)
    sp = server.chain_seq_bucket(s, bp)
    if not server._chain_aligned(bp, sp):
        fail(f"{where}: ({bp}, {sp}) is not chain-aligned")
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int64))
    toks = torch.zeros((bp, sp), dtype=torch.int64)
    toks[:b, :s] = prompt
    toks = toks.to(server.device)
    server.prefill_chained(bp, sp, toks, last=s - 1)  # warm: executables
    torch.cuda.synchronize()
    c0, n0 = chain_counters(server.engine), kernels.launch_counts()
    sig0 = chain_gemm_launches(server)
    last, cache = server.prefill_chained(bp, sp, toks, last=s - 1)
    torch.cuda.synchronize()
    c1, n1 = chain_counters(server.engine), kernels.launch_counts()
    sig1 = chain_gemm_launches(server)
    d = {k: c1[k] - c0[k] for k in CHAIN_KEYS}
    launched = fold_feeds({k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]},
                          where)
    per_sig = {sig: sig1[sig] - sig0[sig] for sig in sig1}
    n_gemm = 1 + sum(
        4 + sum(w in p["mlp"] for w in ("w_in", "w_gate", "w_out"))
        for _, p in server._chain_layers())
    L = cfg.n_layers
    want = {"vortex_gemm": n_gemm, "vortex_gemm.tensor_core": n_gemm,
            "flash_attention_prefill": L,
            "flash_attention_prefill.tensor_core": L}
    copies = d["stage_copies"] + d["unstage_copies"] + d["realize_slices"]
    print(f"{where}: {cfg.name} chained prefill (b={b}, s={s}) at "
          f"({bp}, {sp}): {d}, kernel launches {launched}, per GEMM "
          f"signature (K, N) {per_sig}")
    if copies or d["forwarded"] < L:
        fail(f"{where}: {copies} boundary copies and {d['forwarded']} "
             f"forwarded operands in one chained prefill")
    if launched != want:
        fail(f"{where}: kernel launches {launched}, expected {want}")
    last_e, cache_e = server.prefill_chained(bp, sp, toks, last=s - 1,
                                             eager=True)
    torch.cuda.synchronize()
    if not torch.equal(last, last_e):
        fail(f"{where}: chained logits differ from eager=True (max |diff| "
             f"{(last.float() - last_e.float()).abs().max().item()})")
    for key, entry in cache.items():
        for name, leaf in entry.items():
            if not torch.equal(leaf, cache_e[key][name]):
                fail(f"{where}: cache {key}/{name} differs from eager=True")
    # The "aot" prefill at seq_bucket(s) on the same weights.
    spa = aot.seq_bucket(s)
    toks_a = torch.zeros((bp, spa), dtype=torch.int64)
    toks_a[:b, :s] = prompt
    ref, _, _ = aot._prefill_eager(None, toks_a.to(server.device), s - 1,
                                   aot.kv_bucket(spa))
    err, rel = rel_err(last[:b, :cfg.vocab], ref[:b, :cfg.vocab])
    print(f"{where}: chain vs eager=True bit-identical (logits and "
          f"{sum(len(e) for e in cache.values())} cache leaves); first-token "
          f"logits vs the aot prefill at seq bucket {spa}: "
          f"max_abs_err={err:.4g} rel={rel:.4g} (tolerance {LOGIT_TOL})")
    if not rel <= LOGIT_TOL:
        fail(f"{where}: chained logits disagree with the aot prefill: {rel}")
    return {"bp": bp, "sp": sp, "per_sig": per_sig, "cache": cache,
            "launched": launched}


def chain_forwarding(dev, server) -> int:
    """Phase 4h on the card: handles with NaN-poisoned tails forward into
    the hand-written kernels.  A gemm handle at the MLP's width, q/k/v
    handles into prefill attention, and the chain's own k/v cache buffers
    (tails poisoned) into decode attention: each forwarded result is
    bit-identical to the engine's call on the clean true-extent operands
    (which launches on them as they are) and within tolerance of the
    plain version, with ``forwarded`` counted and no stage copy.  Then the
    two engine paths that keep the staging copy on the card: a handle
    whose buffer is off its bucket restages, and a lazy output at an
    unaligned extent stages (a LazyBucket is bucket-shaped); each makes
    one ``stage_copy`` launch and is bit-identical to the folded call.
    Returns those staging launches."""
    from repro_torch import kernels
    from repro_torch.core.engine import LazyBucket
    from repro_torch.core.workloads import GemmWorkload
    from repro_torch.kernels.attention import flash_attention_plain
    from repro_torch.kernels.gemm import vortex_gemm_plain

    cfg, eng = server.cfg, server.engine
    dt = torch.bfloat16
    g = torch.Generator().manual_seed(21)
    nan = float("nan")

    def rnd(*shape):
        return torch.randn(*shape, generator=g).to(dev, dt)

    def forwarded(kern, run):
        st0 = kern.dispatch_stats.as_dict()
        out = run()
        st1 = kern.dispatch_stats.as_dict()
        return out, {k: st1[k] - st0[k] for k in
                     ("forwarded", "stage_copies", "launches")}

    # gemm: a NaN tail past m inside the bucket.
    d, ff = cfg.d_model, cfg.d_ff
    kern = eng.kernel_for(GemmWorkload(M=None, N=ff, K=d))
    bucket = kern.select(100).padded_m
    m = next(m for m in range(bucket - 1, 0, -1)
             if kern.select(m).padded_m == bucket)
    a, w = rnd(bucket, d), rnd(d, ff)
    clean = a[:m].clone()
    a[m:] = nan
    out, delta = forwarded(
        kern, lambda: kern(LazyBucket(a, m, 0, kern.dispatch_stats), w))
    staged = kern(clean, w)
    torch.cuda.synchronize()
    if delta != {"forwarded": 1, "stage_copies": 0, "launches": 1} \
            or not torch.equal(out, staged):
        fail(f"phase 4h: forwarded gemm handle {delta} or differs from the "
             f"staged call")
    check(f"phase 4h forwarded gemm handle m={m} in bucket {bucket} "
          f"(K={d}, N={ff})", out, vortex_gemm_plain(clean, w), TOL[dt])

    # The staging copy's engine paths: a restaged handle (buffer rows m,
    # extent m - 1, both in the bucket) and a lazy output.
    n0 = kernels.launch_counts()["stage_copy"]
    buf = a[:m].clone()
    buf[m - 1:] = nan
    out, delta = forwarded(
        kern, lambda: kern(LazyBucket(buf, m - 1, 0, kern.dispatch_stats), w))
    folded = kern(clean[:m - 1].contiguous(), w)
    st0 = kern.dispatch_stats.as_dict()
    lazy = kern(clean, w, lazy=True)
    st1 = kern.dispatch_stats.as_dict()
    torch.cuda.synchronize()
    restaged = kernels.launch_counts()["stage_copy"] - n0
    if delta != {"forwarded": 0, "stage_copies": 1, "launches": 1} \
            or st1["stage_copies"] - st0["stage_copies"] != 1 \
            or restaged != 2 or not isinstance(lazy, LazyBucket) \
            or not torch.equal(out, folded) \
            or not torch.equal(lazy.realize(), staged):
        fail(f"phase 4h: restaged handle {delta}, lazy output "
             f"{type(lazy).__name__}, {restaged} staging launches, or a "
             f"result differs from the folded call")
    print(f"phase 4h: a handle off its bucket restaged and a lazy output "
          f"staged: {restaged} stage_copy launches, both bit-identical to "
          f"the folded call")

    # Prefill attention: q/k/v handles with NaN tails past m.
    H, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    params = {"causal": True, "window": None, "softcap": cfg.attn_softcap}
    q, k, v = rnd(1, H, 128, hd), rnd(1, hkv, 128, hd), rnd(1, hkv, 128, hd)
    kern = eng.op_kernel("attention", (q, k, v), params)
    sb = kern.select(128).bucket[0]
    m = next(m for m in range(sb - 1, 0, -1)
             if kern.select(m).bucket[0] == sb)
    q, k, v = rnd(1, H, sb, hd), rnd(1, hkv, sb, hd), rnd(1, hkv, sb, hd)
    clean = [t[:, :, :m].clone() for t in (q, k, v)]
    for t in (q, k, v):
        t[:, :, m:] = nan
    out, delta = forwarded(kern, lambda: kern(
        *(LazyBucket(t, m, 2, kern.dispatch_stats) for t in (q, k, v))))
    staged = kern(*clean)
    torch.cuda.synchronize()
    if delta != {"forwarded": 3, "stage_copies": 0, "launches": 1} \
            or not torch.equal(out, staged):
        fail(f"phase 4h: forwarded attention handles {delta} or differ from "
             f"the staged call")
    check(f"phase 4h forwarded q/k/v handles m={m} in bucket {sb}", out,
          flash_attention_plain(*clean, m), ATTN_TOL[dt])
    return restaged


def chain_decode_forwarding(dev, server, cache, b: int, s: int) -> None:
    """Decode attention reads the chain's own layer-0 k/v cache buffers as
    handles with extent s, their rows past s poisoned with NaN."""
    from repro_torch.core.engine import LazyBucket
    from repro_torch.kernels.attention import flash_attention_plain

    cfg, eng = server.cfg, server.engine
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    k, v = (cache["pos0"][n][0].clone() for n in ("k", "v"))
    clean = [t[:, :, :s].clone() for t in (k, v)]
    for t in (k, v):
        t[:, :, s:] = float("nan")
    q = torch.randn(k.shape[0], H, 1, hd,
                    generator=torch.Generator().manual_seed(22)).to(
                        dev, k.dtype)
    params = {"window": None, "softcap": cfg.attn_softcap}
    kern = eng.op_kernel("decode_attention", (q, k, v, s), params)
    st0 = kern.dispatch_stats.as_dict()
    out = kern(q, LazyBucket(k, s, 2, kern.dispatch_stats),
               LazyBucket(v, s, 2, kern.dispatch_stats), s)
    st1 = kern.dispatch_stats.as_dict()
    staged = kern(q, *clean, s)
    torch.cuda.synchronize()
    delta = {f: st1[f] - st0[f] for f in ("forwarded", "stage_copies")}
    if delta != {"forwarded": 2, "stage_copies": 0} \
            or not torch.equal(out, staged):
        fail(f"phase 4h: decode over the chain's k/v handles {delta} or "
             f"differs from the staged call")
    check(f"phase 4h decode attention over the chain's layer-0 k/v buffers "
          f"(rows {s} of {k.shape[2]}, tails NaN)", out,
          flash_attention_plain(q, *clean, s, q_offset=s - 1, causal=False),
          ATTN_TOL[k.dtype])


def phase_chain(dev, kernels, serve_info: dict) -> dict:
    """Phase 4h: ``VortexServer(prefill="chained")`` on paper-gpt2-124m at
    full width and depth (phase 4's weights), then gemma2-9b at full width
    with 2 layers."""
    import dataclasses

    from repro_torch.launch.serve import Request, VortexServer
    from repro_torch.models.registry import get_config

    aot = serve_info["server"]
    cfg = aot.cfg
    server = VortexServer(cfg, max_cache=aot.max_cache, params=aot.params,
                          prefill="chained")
    rng = np.random.default_rng(30)
    per_sig: dict = {}
    results = []
    for b, s in CHAIN_CASES:
        r = chain_prefill(kernels, server, aot, b, s, rng, "phase 4h")
        for sig, n in r["per_sig"].items():
            per_sig[sig] = per_sig.get(sig, 0) + n
        results.append(r)
    stage_launches = chain_forwarding(dev, server)
    chain_decode_forwarding(dev, server, results[0]["cache"], 1,
                            CHAIN_CASES[0][1])

    # generate() through the chain: every decode step one graph replay,
    # a repeat of the same shape with 0 captures.
    req = Request(tokens=rng.integers(0, cfg.vocab, (2, 100)).astype(
        np.int64), max_new=8)
    steps = req.max_new - 1
    outs = []
    for i in range(2):
        g0 = dict(server.stats)
        outs.append(server.generate(req))
        moved = {k: server.stats[k] - g0[k] for k in
                 ("chained_prefills", "decode_graph_captures",
                  "decode_graph_replays", "prefill_graph_captures")}
        print(f"phase 4h: generate() through the chain, run {i + 1}: "
              f"{moved}")
        if moved["chained_prefills"] != 1 or \
                moved["decode_graph_replays"] != steps or \
                moved["prefill_graph_captures"] or \
                (i and moved["decode_graph_captures"]):
            fail(f"phase 4h: generate() through the chain: {moved}")
    if not np.array_equal(outs[0], outs[1]):
        fail("phase 4h: two chained generate() runs gave different tokens")
    aot_tokens = aot.generate(req)
    same = np.array_equal(outs[0], aot_tokens)
    print(f"phase 4h: chained tokens {outs[0].tolist()} vs aot "
          f"{aot_tokens.tolist()} (identical={same}; bf16 through two GEMM "
          f"kernels, not required)")
    if server.kv_pool.stats()["leases_active"]:
        fail("phase 4h: kv pool leases leaked")
    m = results[0]["bp"] * results[0]["sp"]
    info = {"engine": server.engine, "per_sig": per_sig, "m": m,
            "prefills": len(CHAIN_CASES), "stage_launches": stage_launches}
    del server, results
    free_cuda()

    # gemma2-9b at full width, 2 layers: window 4096, softcaps, d = 256.
    g2 = dataclasses.replace(get_config(GEMMA2), n_layers=2)
    server = VortexServer(g2, max_cache=1024, seed=0, prefill="chained")
    r = chain_prefill(kernels, server, server, 1, 100, rng,
                      "phase 4h gemma2-9b (2 layers)")
    print(f"phase 4h: {g2.name} 2 layers windows "
          f"{[sp.window for sp in g2.pattern]} softcaps {g2.attn_softcap}/"
          f"{g2.logit_softcap} d={g2.resolved_head_dim} through the chain ok")
    del server, r
    free_cuda()
    return info


def chain_gemm_rows(dev, chain_info: dict, errs: dict) -> list[dict]:
    """Rows 1b and 1c: the chain's MLP-in GEMM (K = 768, N = 3072) and LM
    head (K = 768, N = 50432) at m = 128 (phase 4h's (1, 128) bucket), at
    the tile and backend the chain's engine selects; launches are phase
    4h's counted chained prefills'."""
    from repro_torch.core.workloads import GemmWorkload
    from repro_torch.kernels.gemm import vortex_gemm, vortex_gemm_plain

    dt = torch.bfloat16
    g = torch.Generator().manual_seed(23)
    eng, M = chain_info["engine"], chain_info["m"]
    rows = []
    for tag, (K, N) in (("1b", (768, 3072)), ("1c", (768, 50432))):
        sel = eng.kernel_for(GemmWorkload(M=None, N=N, K=K)).select(M)
        bm, bn, bk = sel.strategy.l1
        be = sel.strategy.backend
        a = torch.randn(M, K, generator=g).to(dev, dt)
        b = torch.randn(K, N, generator=g).to(dev, dt)

        def gemm(a=a, b=b, bm=bm, bn=bn, bk=bk, be=be, tma=True):
            return vortex_gemm(a, b, M, block_m=bm, block_n=bn, block_k=bk,
                               backend=be, tma=tma)

        err = check(f"vortex_gemm row {tag} at the chain's shape", gemm(),
                    vortex_gemm_plain(a, b, M), TOL[dt])
        errs["vortex_gemm"] = max(errs["vortex_gemm"], err)
        bnd, by = bound_ms(2 * (M * K + K * N + M * N), 2 * M * N * K, dt)
        rows.append(timed(
            {
                "name": "vortex_gemm", "route": "cuda",
                "source": "src/repro_torch/csrc/gemm.cu",
                "replaces": "src/repro/kernels/gemm.py:110",
                "launches": chain_info["per_sig"].get((K, N), "not counted"),
                "max_abs_err": errs["vortex_gemm"],
                "bound_ms": bnd, "bound_by": by,
                "shape": f"row {tag}: M={M} N={N} K={K} blocks=({bm},{bn},"
                         f"{bk}) {be} bf16, the chained prefill",
            },
            ms=gemm,
            plain_ms=lambda a=a, b=b: vortex_gemm_plain(a, b, M),
            library_ms=lambda a=a, b=b: torch.matmul(a, b),
            cp_async_ms=lambda gemm=gemm: gemm(tma=False),
        ))
    torch.cuda.synchronize()
    return rows


STREAM_GEMM = (1024, 3072, 3072)  # M, N, K: the GEMM stream's dominant call
SQUARE_TILES = ((128, 128, 64), (128, 256, 64))


def graphed_ms(calls: list, rounds: int = 10) -> float:
    """Device ms of one call in a CUDA graph of ``calls`` (one launch
    each), from CUDA events around ``rounds`` replays: the mean."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:  # warm: builds, tensor maps, attributes
            c()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / rounds / len(calls)


def stream_gemm_row(dev, errs: dict) -> dict:
    """Row 1d: the GEMM stream's dominant call (M 1,024, K = N = 3,072) at
    the tile the lattice selects for it, timed as phase 5 times every row,
    and its kernels against each other: the TMA kernel with and without
    the A multicast, the cp.async kernel and ``torch.matmul``, each as 20
    launches in a CUDA graph over 4 weights in turn (75 MB, past the 50 MB
    L2), in turns (cp.async, TMA, multicast, multicast, TMA, cp.async;
    the means); then the same shape at the square tiles the plan builds."""
    from repro_torch import kernels, vortex
    from repro_torch.core.workloads import GemmWorkload
    from repro_torch.kernels.gemm import (
        tensor_core_plan,
        vortex_gemm,
        vortex_gemm_plain,
    )

    dt = torch.bfloat16
    M, N, K = STREAM_GEMM
    g = torch.Generator().manual_seed(36)
    sel = vortex.Engine().kernel_for(
        GemmWorkload(M=None, N=N, K=K)).select(M)
    bm, bn, bk = sel.strategy.l1
    be = sel.strategy.backend
    a = torch.randn(M, K, generator=g).to(dev, dt)
    ws = [(torch.randn(K, N, generator=g) * K ** -0.5).to(dev, dt)
          for _ in range(4)]

    def call(w, tile=(bm, bn, bk), **kw):
        return vortex_gemm(a, w, M, block_m=tile[0], block_n=tile[1],
                           block_k=tile[2], backend=be, **kw)

    n0 = kernels.launch_counts()
    err = check(f"vortex_gemm row 1d M={M} N={N} K={K}", call(ws[0]),
                vortex_gemm_plain(a, ws[0], M), TOL[dt])
    torch.cuda.synchronize()
    moved = fold_feeds({k: v - n0[k] for k, v in kernels.launch_counts()
                        .items() if v != n0[k]}, "row 1d")
    print(f"row 1d: tile ({bm}, {bn}, {bk}) {be}, launches {moved}")
    errs["vortex_gemm"] = max(errs["vortex_gemm"], err)
    variants = {
        "cp_async": dict(tma=False),
        "tma": dict(multicast=False),
        "tma_multicast": {},
    }
    graph = {name: [] for name in (*variants, "library")}
    for name in (*variants, *reversed(variants)):
        kw = variants[name]
        graph[name].append(graphed_ms(
            [lambda w=ws[i % 4], kw=kw: call(w, **kw) for i in range(20)]))
    graph["library"].append(graphed_ms(
        [lambda w=ws[i % 4]: torch.matmul(a, w) for i in range(20)]))
    square = {}
    for tile in SQUARE_TILES:
        try:
            tensor_core_plan(*tile)
        except ValueError as e:
            square[str(tile)] = f"not built: {e}"
            continue
        check(f"vortex_gemm row 1d at the square tile {tile}",
              call(ws[0], tile), vortex_gemm_plain(a, ws[0], M), TOL[dt])
        square[str(tile)] = graphed_ms(
            [lambda w=ws[i % 4], t=tile: call(w, t) for i in range(20)])
    bnd, by = bound_ms(2 * (M * K + K * N + M * N), 2 * M * N * K, dt)
    row = timed(
        {
            "name": "vortex_gemm", "route": "cuda",
            "source": "src/repro_torch/csrc/gemm.cu",
            "replaces": "src/repro/kernels/gemm.py:110",
            "launches": "not counted (the GEMM stream's call)",
            "max_abs_err": err,
            "bound_ms": bnd, "bound_by": by,
            "shape": f"row 1d: M={M} N={N} K={K} blocks=({bm},{bn},{bk}) "
                     f"{be} bf16, the GEMM stream's dominant call",
        },
        ms=lambda: call(ws[0]),
        plain_ms=lambda: vortex_gemm_plain(a, ws[0], M),
        library_ms=lambda: torch.matmul(a, ws[0]),
        cp_async_ms=lambda: call(ws[0], tma=False),
        tma_ms=lambda: call(ws[0], multicast=False),
    )
    row["graph_ms"] = {k: sum(v) / len(v) for k, v in graph.items()}
    row["graph_ms_each"] = graph
    row["square_tile_graph_ms"] = square
    flops = 2.0 * M * N * K
    print(f"row 1d: graphed ms {row['graph_ms']} (TFLOP/s "
          f"{ {k: flops / v / 1e9 for k, v in row['graph_ms'].items()} }), "
          f"square tiles {square}, bound {bnd:.4f} ms ({by})")
    torch.cuda.synchronize()
    return row


def gemm_rows_only(dev, kernels, errs: dict) -> list[dict]:
    """``--gemm-rows``: phases 3 and 3b (their shapes and tiles), then
    rows 1, 1b, 1c, 1d and 4; 1b and 1c at a default engine's tiles for
    the chain's m = 128."""
    from repro_torch import vortex

    gemm_info = phase_gemm(dev, kernels)
    conv_info = phase_conv(dev, kernels)
    rows = phase_time(dev, gemm_info, None, errs)
    rows += chain_gemm_rows(dev, {"engine": vortex.Engine(), "m": 128,
                                  "per_sig": {}}, errs)
    rows.append(stream_gemm_row(dev, errs))
    rows += phase_time_moe_conv(dev, None, conv_info, errs)
    return rows


# ---------------------------------------------------------------------------
# Phases 4c-4f: continuous batching (ContinuousScheduler) on the dense family
# ---------------------------------------------------------------------------


def sched_requests(rng, cfg, n, rows, prompt, max_new):
    """``n`` requests of ``rows`` (lo, hi) rows, ``prompt`` (lo, hi) tokens
    and ``max_new`` (lo, hi) new tokens, bounds inclusive."""
    from repro_torch.launch.serve import Request

    reqs = []
    for _ in range(n):
        b = int(rng.integers(rows[0], rows[1] + 1))
        s = int(rng.integers(prompt[0], prompt[1] + 1))
        reqs.append(Request(
            tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
            max_new=int(rng.integers(max_new[0], max_new[1] + 1)),
        ))
    return reqs


def serve_scheduled(kernels, server, reqs, *, batch_rows: int, where: str,
                    compare: bool = True, eager_check: bool = False,
                    on_sched=None) -> dict:
    """Submit ``reqs`` to a ``ContinuousScheduler`` over ``server``, drain,
    close, and check: every request a token array of its shape, every
    batched step n_layers decode-attention launches on decode.split_kv, one
    prefill launch per layer per admission (each on prefill.tensor_core at
    bf16), 0 padded calls, the lease ledger back to 0.  With ``compare``,
    the first step whose rows sit at different positions (the first step
    of a one-row scheduler) is copied before it runs -- cache, tokens and
    per-row pos -- and replayed under impl="torch"; its logits must agree
    within LOGIT_TOL.  With ``eager_check`` (phase 4g) the same copied step
    also runs eagerly (``graphs=False``) on the card, and its logits must be
    bit-identical to the graph's.  Every step must be one graph replay.
    Host seconds in prefills and decode steps are taken
    around each (synchronized: the scheduler reads each result back right
    after it anyway); copying the step is left out of the wall time.
    ``on_sched`` is called with the scheduler before the first submit."""
    from repro_torch.launch.scheduler import ContinuousScheduler
    from repro_torch.launch.serve import VortexServer

    cfg = server.cfg
    L = cfg.n_layers
    sched = ContinuousScheduler(server, batch_rows=batch_rows)
    if on_sched is not None:
        on_sched(sched)
    real_prefill, real_decode = server.prefill, server.decode_vec
    per_step: list[tuple[int, int]] = []
    # Each step's active rows and the shared cache's length it ran at.
    step_rows: list[tuple[int, int]] = []
    secs = {"prefill": 0.0, "decode": 0.0, "copy": 0.0}
    cap: dict = {}

    stacked = {"prefill": set(), "decode": set()}  # stacked grouped launches

    def prefill(tokens):
        n0 = kernels.launch_counts()["vortex_grouped_gemm.stacked"]
        t = time.perf_counter()
        out = real_prefill(tokens)
        torch.cuda.synchronize()
        secs["prefill"] += time.perf_counter() - t
        stacked["prefill"].add((
            server.batch_bucket(tokens.shape[0]),
            kernels.launch_counts()["vortex_grouped_gemm.stacked"] - n0))
        return out

    def decode_vec(cache, tokens, pos):
        active = [r.pos_next for r in sched.rows if r is not None]
        step_rows.append((len(active), sched.kvb))
        take = compare and not cap and (
            len(set(active)) >= 2 or batch_rows == 1)
        if take:
            t = time.perf_counter()
            cap.update(
                cache={k: {n: leaf.clone() for n, leaf in e.items()}
                       for k, e in cache.items()},
                tokens=tokens.clone(), pos=pos.clone(),
                slots=[i for i, r in enumerate(sched.rows) if r is not None],
                kvb=sched.kvb,
            )
            torch.cuda.synchronize()
            secs["copy"] += time.perf_counter() - t
        n0 = kernels.launch_counts()
        t = time.perf_counter()
        logits = real_decode(cache, tokens, pos)
        torch.cuda.synchronize()
        secs["decode"] += time.perf_counter() - t
        n = kernels.launch_counts()
        per_step.append((
            n["flash_attention_decode"] - n0["flash_attention_decode"],
            n["flash_attention_decode.split_kv"]
            - n0["flash_attention_decode.split_kv"],
        ))
        stacked["decode"].add(n["vortex_grouped_gemm.stacked"]
                              - n0["vortex_grouped_gemm.stacked"])
        if take:
            cap["logits"] = logits.clone()
        return logits

    server.prefill, server.decode_vec = prefill, decode_vec
    kernels.reset_launch_counts()
    g0 = dict(server.stats)
    t0 = time.perf_counter()
    try:
        rids = [sched.submit(r) for r in reqs]
        res = sched.drain()
        torch.cuda.synchronize()
    finally:
        del server.prefill, server.decode_vec  # the class's methods again
    wall = time.perf_counter() - t0 - secs["copy"]
    counts = kernels.launch_counts()
    sched.close()
    st = server.engine_dispatch_stats()

    tokens = 0
    for rid, r in zip(rids, reqs):
        out = res.get(rid)
        if not isinstance(out, np.ndarray):
            fail(f"{where}: request {rid} resolved to {out!r}")
        if out.shape != (r.tokens.shape[0], r.max_new):
            fail(f"{where}: request {rid} output shape {out.shape}")
        if not ((out >= 0) & (out < cfg.vocab)).all():
            fail(f"{where}: token outside the vocabulary")
        tokens += out.size
    steps = sched.stats["steps"]
    graphs = {k: server.stats[k] - g0[k]
              for k in ("decode_graph_captures", "decode_graph_replays",
                        "prefill_graph_captures", "prefill_graph_replays")}
    if graphs["prefill_graph_replays"] != sched.stats["admitted"]:
        fail(f"{where}: {graphs['prefill_graph_replays']} prefill graph "
             f"replays for {sched.stats['admitted']} admissions")
    if server.graphs is None or graphs["decode_graph_replays"] != steps:
        fail(f"{where}: expected one graph replay per batched step, got "
             f"{graphs} for {steps} steps")
    if len(per_step) != steps or any(p != (L, L) for p in per_step):
        fail(f"{where}: expected {L} decode-attention launches on "
             f"decode.split_kv in each of {steps} steps, got "
             f"{sorted(set(per_step))}")
    if counts["flash_attention_prefill"] != L * sched.stats["admitted"]:
        fail(f"{where}: {counts['flash_attention_prefill']} prefill-attention "
             f"launches for {sched.stats['admitted']} admissions")
    if cfg.dtype == "bfloat16":
        all_tensor_core(counts, where)
    padded = (st["attention"]["padded_calls"]
              + st["decode_attention"]["padded_calls"]
              + sched.stats["padded_calls"])
    if padded:
        fail(f"{where}: {padded} padded calls")
    if st["kv_pool"]["leases_active"] != 0:
        fail(f"{where}: kv pool leases leaked: {st['kv_pool']}")
    # Every MoE projection of a batched bf16 decode step stacks its one-row
    # groups (r = batch_rows, C = 1); a one-row prefill is one group.
    n_moe = cfg.n_groups * sum(sp.mlp == "moe" for sp in cfg.pattern)
    want = 3 * n_moe if batch_rows > 1 and cfg.dtype == "bfloat16" else 0
    one_row = {n for bp, n in stacked["prefill"] if bp == 1}
    if stacked["decode"] - {want} or one_row - {0}:
        fail(f"{where}: stacked grouped-GEMM launches a decode step "
             f"{sorted(stacked['decode'])} (expected {want}), a one-row "
             f"prefill {sorted(one_row)} (expected 0)")
    rows = [n for n, _ in step_rows]
    print(f"{where}: {cfg.name} n_layers={L} requests={len(reqs)} "
          f"tokens={tokens} steps={steps} rows_per_step_mean="
          f"{np.mean(rows) if rows else 0:.3f} rows_per_step={rows} "
          f"wall_s={wall:.3f} prefill_s={secs['prefill']:.3f} "
          f"decode_s={secs['decode']:.3f} "
          f"other_s={wall - secs['prefill'] - secs['decode']:.3f} "
          f"kvb={sorted({kvb for _, kvb in step_rows})} "
          f"graph_captures={graphs['decode_graph_captures']} "
          f"graph_replays={graphs['decode_graph_replays']} "
          f"prefill_graph_captures={graphs['prefill_graph_captures']} "
          f"prefill_graph_replays={graphs['prefill_graph_replays']} "
          f"stacked grouped launches a prefill (bp, n)="
          f"{sorted(stacked['prefill'])} "
          f"a decode step={sorted(stacked['decode'])} "
          f"kernel_launches={counts} kv_pool={st['kv_pool']}")

    rel = None
    if compare:
        if "logits" not in cap:
            fail(f"{where}: no step served rows at different positions")
        if eager_check:
            eager = VortexServer(cfg, max_cache=server.max_cache,
                                 params=server.params, graphs=False)
            copy = {k: {n: leaf.clone() for n, leaf in e.items()}
                    for k, e in cap["cache"].items()}
            want = eager.decode_vec(copy, cap["tokens"], cap["pos"])
            same = torch.equal(want, cap["logits"])
            toks = (want.argmax(-1) == cap["logits"].argmax(-1)).all()
            print(f"phase 4g: {cfg.name} one mixed-progress step (rows at "
                  f"pos {cap['pos'][cap['slots']].tolist()}, cache "
                  f"{cap['kvb']}): graph replay vs eager step logits "
                  f"bit-identical={same}, tokens identical={bool(toks)}")
            if not same:
                fail(f"phase 4g: {cfg.name} graphed logits differ from the "
                     f"eager step's")
            del eager, copy, want
        plain = VortexServer(cfg, max_cache=server.max_cache,
                             params=server.params, impl="torch",
                             graphs=False)
        ref = plain.decode_vec(cap["cache"], cap["tokens"], cap["pos"])
        sl = cap["slots"]
        err, rel = rel_err(cap["logits"][sl, :cfg.vocab],
                           ref[sl, :cfg.vocab])
        print(f"{where}: one step's logits vs impl=torch (rows at pos "
              f"{cap['pos'][sl].tolist()}, cache {cap['kvb']}): "
              f"max_abs_err={err:.4g} rel={rel:.4g} (tolerance {LOGIT_TOL})")
        if not rel <= LOGIT_TOL:
            fail(f"{where}: logits disagree with impl='torch': {rel}")
        del plain, ref
    info = {
        "res": [res[rid] for rid in rids], "wall_s": wall, "steps": steps,
        "tokens": tokens, "rows": rows, "secs": secs, "counts": counts,
        "logit_rel": rel, "kvb": [kvb for _, kvb in step_rows],
    }
    if "pos" in cap:
        info["step_kv_len"] = (cap["pos"] + 1).tolist()
        info["step_kvb"] = cap["kvb"]
    cap.clear()
    return info


def param_bytes(tree: dict) -> int:
    return sum(
        param_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
        for v in tree.values()
    )


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def free_cuda() -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


class LadderWatch:
    """The DispatchStats of every engine kernel built while the script
    runs (servers' engines and those inside the benchmark payload too),
    kept for the whole run, to hold each phase before 7 to ``fallbacks ==
    quarantined == 0`` on every kernel built so far: with no fault plan
    installed the degradation ladder must never fire, or it would hide a
    kernel that fails on the main path.  A server built in one phase and
    reused by a later one is held in both."""

    def __init__(self):
        from repro_torch.core.engine import VortexKernel

        self.stats: list = []
        init = VortexKernel.__init__

        def tracked(kern, *args, **kwargs):
            init(kern, *args, **kwargs)
            self.stats.append(kern.dispatch_stats)

        VortexKernel.__init__ = tracked

    def check(self, where: str, upto: int | None = None) -> str:
        """Fails unless the ladder stayed silent on every kernel built so
        far (on the first ``upto`` of them, when given)."""
        from repro_torch.runtime import faults

        if faults.ACTIVE is not None:
            fail(f"{where}: a fault plan is installed")
        held = self.stats[:upto]
        loud = [st for st in held if st.fallbacks or st.quarantined]
        if loud:
            fail(f"{where}: the degradation ladder fired with no plan "
                 f"installed: {[st.as_dict() for st in loud]}")
        return f"ladder silent on the {len(held)} engine kernels held"


def phase_gemma2(kernels) -> dict:
    """Phases 4c and 4d: gemma2-9b at full width and depth."""
    from repro_torch.launch.serve import Request, VortexServer
    from repro_torch.models.registry import get_config

    cfg = get_config(GEMMA2)
    t0 = time.perf_counter()
    server = VortexServer(cfg, max_cache=16384, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"server: {cfg.name} n_layers={cfg.n_layers} d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab} dtype={cfg.dtype} "
          f"windows={[sp.window for sp in cfg.pattern]} softcaps="
          f"{cfg.attn_softcap}/{cfg.logit_softcap} "
          f"params_gb={param_bytes(server.params) / 1e9:.2f} "
          f"init_s={init_s:.2f}")
    reqs = sched_requests(np.random.default_rng(0), cfg, 16, (1, 4),
                          (16, 512), (4, 32))
    t0 = time.perf_counter()
    # The scheduler replays vector-form graphs captured at first use; the
    # scalar-form warmup captures would park a cache per bucket (GBs).
    server.warmup(max_batch=SCHED_ROWS, m_max=512, max_new=32, capture=False)
    warmup_s = time.perf_counter() - t0
    c = serve_scheduled(kernels, server, reqs, batch_rows=SCHED_ROWS,
                        where="phase 4c", eager_check=True)
    print(f"phase 4c: init_s={init_s:.2f} warmup_s={warmup_s:.3f} "
          f"serve_s={c['wall_s']:.3f} admissions_s={c['secs']['prefill']:.3f} "
          f"(graphed prefills, each key captured at its first admission) "
          f"peak_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
    big = max(reqs, key=lambda r: r.tokens.size)

    rng = np.random.default_rng(1)
    long_req = Request(
        tokens=rng.integers(0, cfg.vocab, (1, LONG_PROMPT)).astype(np.int64),
        max_new=4)
    d = serve_scheduled(kernels, server, [long_req], batch_rows=1,
                        where="phase 4d")
    window = cfg.pattern[0].window
    if not min(d["kvb"]) > 2 * window:
        fail(f"phase 4d: kv buckets {d['kvb']} do not pass 2 x {window}")
    sp = server.seq_bucket(LONG_PROMPT)
    print(f"phase 4d: prompt {LONG_PROMPT} at seq bucket {sp}, kv buckets "
          f"{sorted(set(d['kvb']))} > 2 x window {window}: the local layers' "
          f"decode read the window slice")
    info = {
        "cfg": cfg, "c": c, "d": d, "long_sp": sp,
        "big_bp": server.batch_bucket(big.tokens.shape[0]),
        "big_sp": server.seq_bucket(big.tokens.shape[1]),
        "prefill_launches": c["counts"]["flash_attention_prefill"]
        + d["counts"]["flash_attention_prefill"],
        "decode_launches": c["counts"]["flash_attention_decode"]
        + d["counts"]["flash_attention_decode"],
    }
    del server
    free_cuda()
    return info


def phase_dense_2l(kernels) -> dict:
    """Phase 4e: danube, phi4-mini and starcoder2 at full width, 2 layers."""
    import dataclasses

    from repro_torch.launch.serve import VortexServer
    from repro_torch.models.registry import get_config

    out = {}
    for i, arch in enumerate(DENSE_2L):
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        server = VortexServer(cfg, max_cache=1024, seed=0)
        reqs = sched_requests(np.random.default_rng(10 + i), cfg, 4, (1, 2),
                              (16, 128), (4, 8))
        print(f"server: {cfg.name} (2 of {get_config(arch).n_layers} layers) "
              f"d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x"
              f"{cfg.resolved_head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab}")
        r = serve_scheduled(kernels, server, reqs, batch_rows=SCHED_ROWS,
                            where=f"phase 4e {arch}")
        big = max(reqs, key=lambda q: q.tokens.size)
        r.update(cfg=cfg, bp=server.batch_bucket(big.tokens.shape[0]),
                 sp=server.seq_bucket(big.tokens.shape[1]))
        out[arch] = r
        del server
        free_cuda()
    return out


def phase_gemma2_f32(kernels) -> dict:
    """Phase 4f: gemma2-9b at full width, 2 layers, float32: scheduler
    tokens equal serial generate()'s."""
    import dataclasses

    from repro_torch.launch.serve import VortexServer
    from repro_torch.models.registry import get_config

    cfg = dataclasses.replace(get_config(GEMMA2), n_layers=2,
                              dtype="float32")
    server = VortexServer(cfg, max_cache=1024, seed=0)
    reqs = sched_requests(np.random.default_rng(20), cfg, 4, (1, 2),
                          (16, 96), (4, 8))
    serial = [server.generate(r) for r in reqs]
    r = serve_scheduled(kernels, server, reqs, batch_rows=SCHED_ROWS,
                        where="phase 4f", compare=False)
    for i, (got, want) in enumerate(zip(r["res"], serial)):
        if not np.array_equal(got, want):
            fail(f"phase 4f: request {i}: scheduler tokens {got.tolist()} != "
                 f"serial generate() {want.tolist()}")
    print(f"phase 4f: {cfg.name} float32, 2 layers: scheduler tokens equal "
          f"serial generate() for all {len(reqs)} requests "
          f"({sum(x.size for x in serial)} tokens)")
    del server
    free_cuda()
    return r


# ---------------------------------------------------------------------------
# Phase 4j: MLA and Mamba (deepseek-v2, falcon-mamba, jamba)
# ---------------------------------------------------------------------------

# (arch, layers served: None = full depth).  jamba's pattern is 8 layers
# long (one attention layer, four MoE layers), so one group is the least.
MLA_MAMBA = (("deepseek-v2-236b", 2), ("falcon-mamba-7b", None),
             ("jamba-v0.1-52b", 8))
MLA_MAMBA_MAX_NEW = 8
C11_PROMPT = 37  # unaligned: served in a 64-row seq bucket
# Held whole in float32 (a copy of the served weights): bf16 rounding
# differences between two sequence lengths grow through 64 random-weight
# Mamba layers past LOGIT_TOL, while each layer's state agrees.
C11_WHOLE_F32 = ("falcon-mamba-7b",)


def unaligned_requests(rng, cfg, server, n: int) -> list:
    """``n`` requests of 1-2 rows whose prompts (16-256 tokens) each fall
    short of their seq bucket, with max_new 8."""
    from repro_torch.launch.serve import Request

    reqs = []
    while len(reqs) < n:
        b, s = int(rng.integers(1, 3)), int(rng.integers(16, 257))
        if server.seq_bucket(s) == s:
            continue
        reqs.append(Request(
            tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
            max_new=MLA_MAMBA_MAX_NEW))
    return reqs


def state_leaves(cache: dict) -> torch.Tensor:
    """Every Mamba state leaf of a cache, flattened into one f32 vector."""
    return torch.cat([leaf.float().flatten() for e in cache.values()
                      for name, leaf in e.items() if name in ("conv", "ssm")])


def c11_prefills(server, cfg, params, toks: np.ndarray) -> dict:
    """The prefill of ``toks`` at its exact length, padded to its seq
    bucket with ``last = s - 1``, and padded with ``last`` on the bucket's
    last row (the pad scanned into the state, as the reference does):
    ``{name: (logits, cache)}``."""
    from repro_torch.models.model import prefill_step

    b, s = toks.shape
    sp = server.seq_bucket(s)
    padded = torch.zeros((b, sp), dtype=torch.int64)
    padded[:, :s] = torch.from_numpy(toks)
    padded = padded.to(server.device)
    out = {}
    with server.engine.use():
        for name, t, last in (("exact", padded[:, :s], s - 1),
                              ("padded", padded, s - 1),
                              ("pad_scanned", padded, sp - 1)):
            logits, cache, _ = prefill_step(
                cfg, params, t, cache_len=server.kv_bucket(sp), last=last)
            out[name] = (logits[:, :cfg.vocab], cache)
    torch.cuda.synchronize()
    return out


def check_c11(server, cfg, toks: np.ndarray, whole_f32: bool) -> dict:
    """C11 on the card: the prefill of ``toks`` padded to its seq bucket
    with ``last = s - 1`` against the prefill of the s real rows.  MoE
    layers run at a no-drop capacity here (the capacity follows the token
    count, so a drop would legitimately differ between the two lengths).

    * bf16, the served weights: the first Mamba layer's conv and ssm state
      within TOL[bf16] (2^-7), where a pad scanned into the state (the
      reference's behaviour, shown beside it) is off by about 1.
    * The whole model: the next-token logits and every Mamba layer's
      state within LOGIT_TOL in bf16; with ``whole_f32`` (falcon-mamba's
      64 layers, through which bf16 rounding differences of the two
      lengths grow past LOGIT_TOL) within TOL[f32] on a float32 copy of
      the served weights."""
    import dataclasses

    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    out = c11_prefills(server, cfg, server.params, toks)
    mamba = [f"pos{i}" for i, sp_ in enumerate(cfg.pattern)
             if sp_.mixer == "mamba"]
    res = {"s": toks.shape[1], "sp": server.seq_bucket(toks.shape[1])}
    checks = []
    for name in ("padded", "pad_scanned"):
        _, res[f"{name}_logit_rel"] = rel_err(out[name][0], out["exact"][0])
        if mamba:
            first = [(out[name][1][mamba[0]][k][0], out["exact"][1][mamba[0]]
                      [k][0]) for k in ("conv", "ssm")]
            res[f"{name}_layer0_state_rel"] = max(rel_err(a, e)[1]
                                                  for a, e in first)
            _, res[f"{name}_state_rel"] = rel_err(
                state_leaves(out[name][1]), state_leaves(out["exact"][1]))
    if mamba:
        checks.append(("padded_layer0_state_rel", TOL[torch.bfloat16]))
    if whole_f32:
        f32 = dataclasses.replace(cfg, dtype="float32")
        p32 = {k: ({kk: ({k3: v3.float() for k3, v3 in vv.items()}
                         if isinstance(vv, dict) else vv.float())
                    for kk, vv in v.items()} if isinstance(v, dict)
                   else v.float()) for k, v in server.params.items()}
        out32 = c11_prefills(server, f32, p32, toks)
        del p32
        _, res["f32_padded_logit_rel"] = rel_err(out32["padded"][0],
                                                 out32["exact"][0])
        _, res["f32_padded_state_rel"] = rel_err(
            state_leaves(out32["padded"][1]), state_leaves(out32["exact"][1]))
        del out32
        checks += [("f32_padded_logit_rel", TOL[torch.float32]),
                   ("f32_padded_state_rel", TOL[torch.float32])]
    else:
        checks.append(("padded_logit_rel", LOGIT_TOL))
        if mamba:
            checks.append(("padded_state_rel", LOGIT_TOL))
    del out
    print(f"phase 4j: {cfg.name} C11 prefill of {res['s']} real rows in a "
          f"{res['sp']}-row bucket vs the exact-length prefill: "
          + " ".join(f"{k}={v:.4g}" for k, v in res.items()
                     if k.endswith("rel"))
          + "; checked: " + ", ".join(f"{k} <= {tol:.3g}"
                                      for k, tol in checks))
    for key, tol in checks:
        if not res[key] <= tol:
            fail(f"phase 4j: {cfg.name} {key} {res[key]} > {tol}: the "
                 f"padded prefill's state is not the exact prefill's")
    return res


def plain_mla_mamba_times(dev, cfg, server, bp: int, sp: int, kvb: int,
                          kv_len: int, smi: str) -> dict:
    """Device time per call of the plain-torch code the new mixers run on
    the card, at the shapes the served requests gave it: MLA's prefill
    ``chunked_attention`` and one absorbed decode step of one layer, the
    Mamba chunk scan and one Mamba layer's prefill and decode."""
    from repro_torch.kernels.ref import chunked_attention
    from repro_torch.models.layers import (
        ATTN_CHUNK,
        _ssm_chunk_scan,
        mamba_forward,
        mla_forward,
    )
    from repro_torch.models.model import _slice, make_cache

    dt = torch.bfloat16
    g = torch.Generator(dev).manual_seed(9)
    times = {}
    x = torch.randn(bp, sp, cfg.d_model, generator=g, device=dev).to(dt)
    xd = x[:, :1].contiguous()
    pos = torch.full((bp,), kv_len - 1, dtype=torch.int32, device=dev)
    if cfg.mla is not None:
        m, H = cfg.mla, cfg.n_heads
        qk = m.qk_nope_dim + m.qk_rope_dim
        q, k = (torch.randn(bp, H, sp, qk, generator=g, device=dev).to(dt)
                for _ in range(2))
        v = torch.randn(bp, H, sp, m.v_head_dim, generator=g,
                        device=dev).to(dt)
        times[f"mla chunked_attention q=({bp},{H},{sp},{qk}) "
              f"v dim {m.v_head_dim}"] = device_ms(
            lambda: chunked_attention(q, k, v, causal=True, chunk=ATTN_CHUNK),
            iters=20)
        p = _slice(server.params["pos0"], 0)["mla"]
        cache = _slice(make_cache(cfg, bp, kvb, dev)["pos0"], 0)
        times[f"mla absorbed decode (one layer) b={bp} cache={kvb}"] = \
            device_ms(lambda: mla_forward(
                p, xd, cfg, mode="decode", positions=pos.reshape(bp, 1),
                cache=cache, pos=pos), iters=20)
    if cfg.ssm is not None:
        s_ = cfg.ssm
        i = next(i for i, spec in enumerate(cfg.pattern)
                 if spec.mixer == "mamba")
        p = _slice(server.params[f"pos{i}"], 0)["mamba"]
        L = min(cfg.scan_chunk, sp)
        a = torch.rand(bp, L, s_.d_inner, s_.d_state, generator=g,
                       device=dev)
        bx = torch.randn(bp, L, s_.d_inner, s_.d_state, generator=g,
                         device=dev)
        h0 = torch.zeros(bp, s_.d_inner, s_.d_state, device=dev)
        times[f"mamba _ssm_chunk_scan ({bp},{L},{s_.d_inner},{s_.d_state}) "
              f"f32"] = device_ms(lambda: _ssm_chunk_scan(a, bx, h0),
                                  iters=10)
        last = torch.full((1,), sp - 1, dtype=torch.long, device=dev)
        times[f"mamba layer prefill x=({bp},{sp},{cfg.d_model})"] = \
            device_ms(lambda: mamba_forward(p, x, cfg, mode="prefill",
                                            last=last), iters=10)
        state = _slice(make_cache(cfg, bp, kvb, dev)[f"pos{i}"], 0)
        times[f"mamba layer decode b={bp}"] = device_ms(
            lambda: mamba_forward(p, xd, cfg, mode="decode", cache=state),
            iters=20)
    for what, ms in times.items():
        print(f"phase 4j: plain torch on the card, {cfg.name} {what}: "
              f"device_ms={ms:.4f} [torch.profiler device time] on {smi}")
    del x, xd
    return times


def step_ms(server, toks: np.ndarray, n: int = 10) -> tuple[float, float]:
    """CUDA-event ms of one "aot" prefill (lease, graph replay, first
    token) and of one graphed decode step against its cache, each the
    mean of ``n`` calls after the key's first."""
    b, s = toks.shape
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    tok, cache, kvb = server.prefill(toks)
    server.release_cache(cache)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        tok, cache, kvb = server.prefill(toks)
        server.release_cache(cache)
    end.record()
    torch.cuda.synchronize()
    prefill = start.elapsed_time(end) / n
    tok, cache, kvb = server.prefill(toks)
    try:
        t = tok[:, None]
        server._decode(cache, t, s, server._decode_seen, kvb)
        torch.cuda.synchronize()
        start.record()
        for _ in range(n):
            server._decode(cache, t, s, server._decode_seen, kvb)
        end.record()
        torch.cuda.synchronize()
    finally:
        server.release_cache(cache)
    return prefill, start.elapsed_time(end) / n


def phase_mla_mamba(dev, kernels, errs, smi: str) -> dict:
    """Phase 4j: deepseek-v2 (MLA, 2 shared + 160 routed experts; 2 of 60
    layers), falcon-mamba-7b (64 Mamba layers, full depth) and jamba-v0.1
    (one 8-layer group: 7 Mamba and 1 attention layer, 4 MoE layers), each
    at full width through serial ``generate()`` with graphs on, bf16,
    seeded init drawn on the card."""
    import dataclasses

    from repro_torch.launch.serve import VortexServer
    from repro_torch.models.registry import get_config

    rows, info = [], {}
    for arch, n_layers in MLA_MAMBA:
        full = get_config(arch)
        cfg = (full if n_layers is None
               else dataclasses.replace(full, n_layers=n_layers))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        server = VortexServer(cfg, max_cache=512, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        eager = VortexServer(cfg, max_cache=512, params=server.params,
                             graphs=False)
        n_moe = cfg.n_groups * sum(sp.mlp == "moe" for sp in cfg.pattern)
        n_attn = cfg.n_groups * sum(sp.mixer == "attn" for sp in cfg.pattern)
        print(f"server: {cfg.name} ({cfg.n_layers} of {full.n_layers} "
              f"layers) d_model={cfg.d_model} pattern="
              f"{[(sp.mixer, sp.mlp) for sp in cfg.pattern]} moe={cfg.moe} "
              f"mla={cfg.mla} ssm={cfg.ssm} vocab={cfg.vocab} "
              f"params_gb={param_bytes(server.params) / 1e9:.2f} "
              f"init_s={init_s:.2f}")
        reqs = unaligned_requests(np.random.default_rng(40), cfg, server, 4)
        steps = sum(r.max_new - 1 for r in reqs)
        per_form = {"prefill": 0, "decode": 0, "prefill_forwards": 0,
                    "decode_forwards": 0, "per_forward": set()}
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with grouped_launches_by_form(kernels, server, per_form):
            outs = [server.generate(r) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        want = [eager.generate(r) for r in reqs]
        st = server.engine_dispatch_stats()
        ds = st["decode_step"]
        print(f"phase 4j: {cfg.name} requests="
              f"{[r.tokens.shape for r in reqs]} seq buckets="
              f"{[server.seq_bucket(r.tokens.shape[1]) for r in reqs]} "
              f"wall_s={wall:.3f} decode_steps={ds['launches']} "
              f"stats={server.stats} kernel_launches={counts}")
        for i, (got, exp) in enumerate(zip(outs, want)):
            r = reqs[i]
            if got.shape != (r.tokens.shape[0], r.max_new) or not (
                    (got >= 0) & (got < cfg.vocab)).all():
                fail(f"phase 4j: {cfg.name} request {i}: tokens {got}")
            if not np.array_equal(got, exp):
                fail(f"phase 4j: {cfg.name} request {i}: graphed tokens "
                     f"{got.tolist()} != eager {exp.tolist()}")
        if ds["launches"] != steps or ds["padded_calls"] != 0:
            fail(f"phase 4j: {cfg.name} {ds['launches']} decode steps for "
                 f"{steps} tokens")
        if (server.stats["decode_graph_replays"] != steps
                or server.stats["prefill_graph_replays"] != len(reqs)):
            fail(f"phase 4j: {cfg.name} expected one graph replay per "
                 f"prefill and per decode step: {server.stats}")
        if st["kv_pool"]["leases_active"] != 0:
            fail(f"phase 4j: {cfg.name} kv pool leases leaked")
        all_tensor_core(counts, f"phase 4j {cfg.name}")
        if (counts["flash_attention_prefill"] != n_attn * len(reqs)
                or counts["flash_attention_decode"] != n_attn * steps):
            fail(f"phase 4j: {cfg.name} expected {n_attn} attention "
                 f"launches per forward: {counts}")
        per_layer = 3 * n_moe
        if (per_form["prefill"] != per_layer * len(reqs)
                or per_form["decode"] != per_layer * steps
                or counts["vortex_grouped_gemm"]
                != per_layer * (len(reqs) + steps)):
            fail(f"phase 4j: {cfg.name} expected {per_layer} grouped-GEMM "
                 f"launches per forward, got {per_form}")
        if counts["vortex_gemm"]:
            fail(f"phase 4j: {cfg.name} launched the GEMM kernel outside "
                 f"the chain")
        print(f"phase 4j: {cfg.name} graphed tokens equal eager tokens for "
              f"{len(reqs)} requests ({sum(o.size for o in outs)} tokens); "
              f"{steps} decode steps, each one replay; attention launches "
              f"prefill={counts['flash_attention_prefill']} decode="
              f"{counts['flash_attention_decode']}; grouped launches "
              f"prefill={per_form['prefill']} decode={per_form['decode']} "
              f"(stacked {per_form.get('prefill_stacked', 0)}, "
              f"{per_form.get('decode_stacked', 0)}); "
              f"mean dropped_frac={server.mean_dropped_frac():.6f}")
        res = {"cfg": cfg, "counts": counts, "per_form": per_form,
               "wall_s": wall, "tokens": sum(o.size for o in outs),
               "init_s": init_s}
        res["c11"] = check_c11(server, cfg, np.random.default_rng(41)
                               .integers(0, cfg.vocab, (1, C11_PROMPT)),
                               whole_f32=arch in C11_WHOLE_F32)
        big = max(reqs, key=lambda q: q.tokens.size)
        bp = server.batch_bucket(big.tokens.shape[0])
        sp = server.seq_bucket(big.tokens.shape[1])
        kv_len = big.tokens.shape[1] + big.max_new - 1
        kvb = server.kv_bucket(sp)
        if kv_len > kvb:
            kvb = server._grown_kv_bucket(kvb, kv_len)
        res["prefill_ms"], res["decode_ms"] = step_ms(server, big.tokens)
        res["plain_ms"] = plain_mla_mamba_times(dev, cfg, server, bp, sp,
                                                kvb, kv_len, smi)
        shape = dict(cfg=cfg, engine=server.engine, server=server, bp=bp,
                     sp=sp, kvb=kvb, kv_len=kv_len, counts=counts,
                     per_form=per_form)
        g = torch.Generator().manual_seed(11)
        if n_moe:
            rows += grouped_rows(dev, shape, errs, g, f", {cfg.name}",
                                 gw=torch.Generator(dev).manual_seed(12))
        if n_attn:
            rows += attention_rows(dev, shape, errs, g, f", {cfg.name}")
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"phase 4j: {cfg.name} prefill (b={big.tokens.shape[0]}, "
              f"s={big.tokens.shape[1]}) at ({bp}, {sp}): "
              f"{res['prefill_ms']:.3f} ms; one decode step after it: "
              f"{res['decode_ms']:.3f} ms [CUDA events]; peak_gb="
              f"{res['peak_gb']:.2f} on {smi}")
        info[arch] = res
        del server, eager, shape
        free_cuda()
    info["rows"] = rows
    return info


# ---------------------------------------------------------------------------
# Phase 4k: the encoder, cross-attention and the vision prefix (whisper-small,
# internvl2-26b)
# ---------------------------------------------------------------------------

# (arch, layers served: None = full depth, max_cache, requests' rows,
# prompt lengths, max_new).  internvl2's prompts hold its 256 image rows
# and then text.
ENC_VLM = (("whisper-small", None, 512, (1, 4), (3, 40), 16),
           ("internvl2-26b", 2, 1024, (1, 2), (257, 400), 8))
C13_PROMPT = 100  # shorter than internvl2's 256-row vision prefix


def b2_launches(server) -> dict:
    """The engine's B2 launches per form: non-causal prefill (whisper's
    encoder), causal prefill and decode (graph replays add theirs)."""
    out = {"noncausal": 0, "causal": 0, "decode": 0}
    for k in server.engine.kernels().values():
        wl = k.workload
        if wl.kind == "attention":
            out["causal" if wl.causal else "noncausal"] += \
                k.dispatch_stats.launches
        elif wl.kind == "decode_attention":
            out["decode"] += k.dispatch_stats.launches
    return out


def short_requests(rng, cfg, server, n: int, rows, prompts, max_new):
    """``n`` requests whose prompts each fall short of their seq bucket."""
    from repro_torch.launch.serve import Request

    reqs = []
    while len(reqs) < n:
        b = int(rng.integers(rows[0], rows[1] + 1))
        s = int(rng.integers(prompts[0], prompts[1] + 1))
        if server.seq_bucket(s) == s:
            continue
        reqs.append(Request(
            tokens=rng.integers(0, cfg.vocab, (b, s)).astype(np.int64),
            max_new=max_new))
    return reqs


def first_logits(server, cfg, toks: np.ndarray) -> torch.Tensor:
    """The "aot" prefill's first-token logits of ``toks`` (rows, vocab),
    eagerly, with the server's zero frontend inputs."""
    from repro_torch.models.model import prefill_step

    b, s = toks.shape
    bp, sp = server.batch_bucket(b), server.seq_bucket(s)
    padded = torch.zeros((bp, sp), dtype=torch.int64)
    padded[:b, :s] = torch.from_numpy(toks)
    with server.engine.use():
        logits, _, _ = prefill_step(
            cfg, server.params, padded.to(server.device),
            cache_len=server.kv_bucket(sp), last=s - 1,
            **server._frontend(bp))
    return logits[:b, :cfg.vocab]


def encoder_b2_check(dev, server, cfg, bp: int) -> float:
    """The encoder's B2 call (non-causal, ``encoder_seq`` frames staged
    into their bucket) against the inline ``chunked_attention``."""
    from repro_torch.kernels.ref import chunked_attention
    from repro_torch.models.layers import ATTN_CHUNK

    g = torch.Generator(dev).manual_seed(13)
    n, hd = cfg.encoder_seq, cfg.resolved_head_dim
    q = torch.randn(bp, cfg.n_heads, n, hd, generator=g, device=dev)
    k, v = (torch.randn(bp, cfg.n_kv_heads, n, hd, generator=g, device=dev)
            for _ in range(2))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    with server.engine.use():
        out = server.engine.dispatch("attention", q, k, v, causal=False,
                                     window=None, softcap=cfg.attn_softcap)
    return check(f"phase 4k: {cfg.name} encoder B2 (non-causal, {n} frames) "
                 f"vs chunked_attention", out,
                 chunked_attention(q, k, v, causal=False, chunk=ATTN_CHUNK),
                 ATTN_TOL[torch.bfloat16])


def plain_encoder_vision_times(dev, cfg, server, bp: int, sp: int,
                               smi: str) -> dict:
    """Device time per call of the plain-torch code the new modules run
    on the card, at the served shapes: whisper's sinusoidal positions, one
    layer's cross K/V projection of ``encoder_out`` (recomputed at every
    step), its cross-attention in a prefill and in a decode step, and the
    whole encoder (its B2 launches included); internvl2's vision-prefix
    overwrite."""
    from repro_torch.kernels.ref import chunked_attention
    from repro_torch.models.layers import ATTN_CHUNK, sinusoid
    from repro_torch.models.model import _encode, _slice

    dt = torch.bfloat16
    g = torch.Generator(dev).manual_seed(14)
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
    times = {}
    if cfg.encoder_decoder:
        n = cfg.encoder_seq
        ap = _slice(server.params["pos0"], 0)["attn"]
        eo = torch.randn(bp, n, d, generator=g, device=dev).to(dt)
        pos = torch.full((bp,), sp, dtype=torch.int32, device=dev)
        times[f"sinusoid decode positions ({bp},1,{d})"] = device_ms(
            lambda: sinusoid(pos.reshape(bp, 1), d))
        times[f"sinusoid prefill positions ({sp},{d})"] = device_ms(
            lambda: sinusoid(torch.arange(sp, device=dev), d))
        times[f"cross K/V projection (one layer) encoder_out=({bp},{n},{d})"] \
            = device_ms(lambda: (eo @ ap["xk"], eo @ ap["xv"]))
        kx, vx = (torch.randn(bp, cfg.n_kv_heads, n, hd, generator=g,
                              device=dev).to(dt) for _ in range(2))
        for rows in (1, sp):
            qx = torch.randn(bp, H, rows, hd, generator=g, device=dev).to(dt)
            times[f"cross chunked_attention q=({bp},{H},{rows},{hd}) over "
                  f"{n} frames"] = device_ms(
                lambda qx=qx: chunked_attention(qx, kx, vx, causal=False,
                                                chunk=ATTN_CHUNK), iters=20)
        frames = torch.zeros(bp, n, d, dtype=dt, device=dev)

        def encode():
            with server.engine.use():
                return _encode(cfg, server.params, frames)

        times[f"encoder ({cfg.n_encoder_layers} layers, B2 included) "
              f"frames=({bp},{n},{d})"] = device_ms(encode, iters=10)
    if cfg.vision_prefix:
        nv = cfg.vision_prefix
        x = torch.randn(bp, sp, d, generator=g, device=dev).to(dt)
        ve = torch.zeros(bp, nv, d, dtype=dt, device=dev)
        times[f"vision-prefix overwrite x=({bp},{sp},{d}) prefix {nv}"] = \
            device_ms(lambda: torch.cat([ve, x[:, nv:]], dim=1))
    for what, ms in times.items():
        print(f"phase 4k: plain torch on the card, {cfg.name} {what}: "
              f"device_ms={ms:.4f} [torch.profiler device time] on {smi}")
    return times


def encoder_row(dev, info: dict, errs: dict, g) -> dict:
    """Row 2j: whisper's encoder self-attention as the engine launches it,
    non-causal, ``encoder_seq`` frames in their bucket (kv_len masks the
    pad).  The bound counts the real frames: q, K, V read and the output
    written once, every query over every key."""
    import torch.nn.functional as F

    from repro_torch.core.workloads import AttentionWorkload
    from repro_torch.kernels.attention import (
        flash_attention,
        flash_attention_plain,
    )

    dt = torch.bfloat16
    cfg, server, bp = info["cfg"], info["server"], info["bp"]
    H, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    n = cfg.encoder_seq
    sel = server.engine.kernel_for(AttentionWorkload(
        seq=None, head_dim=hd, causal=False,
        softcap=cfg.attn_softcap)).select(n)
    sq = sel.bucket[0]
    m1, _, k1 = sel.strategy.l1
    be = sel.strategy.backend
    q = torch.randn(bp, H, sq, hd, generator=g).to(dev, dt)
    k, v = (torch.randn(bp, hkv, sq, hd, generator=g).to(dev, dt)
            for _ in range(2))
    qn, kn, vn = (t[:, :, :n].contiguous() for t in (q, k, v))

    def enc():
        return flash_attention(q, k, v, n, block_q=m1, block_k=k1,
                               backend=be, causal=False)

    err = check("flash_attention prefill, whisper encoder (non-causal) at "
                "the main path's shape", enc(),
                flash_attention_plain(q, k, v, n, causal=False),
                ATTN_TOL[dt])
    errs["flash_attention_prefill"] = max(errs["flash_attention_prefill"],
                                          err)
    nbytes = 2 * (2 * bp * H * n * hd + 2 * bp * hkv * n * hd)
    bnd, by = bound_ms(nbytes, 4.0 * hd * bp * H * n * n, dt)
    return timed(
        {
            "name": f"flash_attention (prefill, {cfg.name} encoder, "
                    f"non-causal)",
            "route": "cuda",
            "source": "src/repro_torch/csrc/attention_tc.cu"
            if be == "tensor_core" else "src/repro_torch/csrc/attention.cu",
            "replaces": "src/repro/kernels/attention.py:125",
            "launches": info["b2"]["noncausal"],
            "max_abs_err": errs["flash_attention_prefill"],
            "bound_ms": bnd, "bound_by": by,
            "shape": f"{cfg.name} encoder q=({bp},{H},{sq},{hd}) kv heads "
                     f"{hkv} kv_len={n} blocks=({m1},{k1}) {be} "
                     f"non-causal bf16",
        },
        ms=enc,
        plain_ms=lambda: flash_attention_plain(q, k, v, n, causal=False),
        library_ms=lambda: F.scaled_dot_product_attention(qn, kn, vn),
    )


def phase_encoder_vision(dev, kernels, errs, smi: str) -> dict:
    """Phase 4k: whisper-small (full width and depth: 12 encoder and 12
    decoder layers) and internvl2-26b (full width, 2 of 48 layers), bf16,
    seeded init drawn on the card, through serial ``generate()`` with
    graphs on."""
    import dataclasses

    from repro_torch.launch.serve import (
        Request,
        VisionPrefixError,
        VortexServer,
    )
    from repro_torch.models.registry import get_config

    rows, info = [], {}
    for arch, n_layers, max_cache, rws, prompts, max_new in ENC_VLM:
        full = get_config(arch)
        cfg = (full if n_layers is None
               else dataclasses.replace(full, n_layers=n_layers))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        server = VortexServer(cfg, max_cache=max_cache, seed=0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        eager = VortexServer(cfg, max_cache=max_cache, params=server.params,
                             graphs=False)
        enc = (f", {cfg.n_encoder_layers} encoder layers over "
               f"{cfg.encoder_seq} frames" if cfg.encoder_decoder else "")
        print(f"server: {cfg.name} ({cfg.n_layers} of {full.n_layers} "
              f"layers{enc}) d_model={cfg.d_model} heads={cfg.n_heads}/"
              f"{cfg.n_kv_heads}x{cfg.resolved_head_dim} d_ff={cfg.d_ff} "
              f"vocab={cfg.vocab} vision_prefix={cfg.vision_prefix} "
              f"rope={cfg.use_rope} params_gb="
              f"{param_bytes(server.params) / 1e9:.2f} init_s={init_s:.2f}")
        reqs = short_requests(np.random.default_rng(50), cfg, server, 4,
                              rws, prompts, max_new)
        steps = sum(r.max_new - 1 for r in reqs)
        n_enc = cfg.n_encoder_layers if cfg.encoder_decoder else 0
        kernels.reset_launch_counts()
        b2_0 = b2_launches(server)
        t0 = time.perf_counter()
        outs = [server.generate(r) for r in reqs]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        b2 = {k: n - b2_0[k] for k, n in b2_launches(server).items()}
        want = [eager.generate(r) for r in reqs]
        st = server.engine_dispatch_stats()
        ds = st["decode_step"]
        print(f"phase 4k: {cfg.name} requests="
              f"{[r.tokens.shape for r in reqs]} seq buckets="
              f"{[server.seq_bucket(r.tokens.shape[1]) for r in reqs]} "
              f"wall_s={wall:.3f} decode_steps={ds['launches']} "
              f"stats={server.stats} kernel_launches={counts} b2={b2}")
        for i, (got, exp) in enumerate(zip(outs, want)):
            r = reqs[i]
            if got.shape != (r.tokens.shape[0], r.max_new) or not (
                    (got >= 0) & (got < cfg.vocab)).all():
                fail(f"phase 4k: {cfg.name} request {i}: tokens {got}")
            if not np.array_equal(got, exp):
                fail(f"phase 4k: {cfg.name} request {i}: graphed tokens "
                     f"{got.tolist()} != eager {exp.tolist()}")
        if ds["launches"] != steps or ds["padded_calls"] != 0:
            fail(f"phase 4k: {cfg.name} {ds['launches']} decode steps for "
                 f"{steps} tokens")
        if (server.stats["decode_graph_replays"] != steps
                or server.stats["prefill_graph_replays"] != len(reqs)):
            fail(f"phase 4k: {cfg.name} expected one graph replay per "
                 f"prefill and per decode step: {server.stats}")
        if st["kv_pool"]["leases_active"] != 0:
            fail(f"phase 4k: {cfg.name} kv pool leases leaked")
        all_tensor_core(counts, f"phase 4k {cfg.name}")
        per_prefill = {"noncausal": n_enc, "causal": cfg.n_layers}
        if (b2 != {"noncausal": n_enc * len(reqs),
                   "causal": cfg.n_layers * len(reqs),
                   "decode": cfg.n_layers * steps}
                or counts["flash_attention_prefill"]
                != (n_enc + cfg.n_layers) * len(reqs)
                or counts["flash_attention_decode"] != cfg.n_layers * steps):
            fail(f"phase 4k: {cfg.name} expected {per_prefill} prefill "
                 f"launches a prefill and {cfg.n_layers} decode launches a "
                 f"step: engine {b2}, kernels {counts}")
        if counts["vortex_gemm"] or counts["vortex_grouped_gemm"]:
            fail(f"phase 4k: {cfg.name} launched a GEMM kernel: {counts}")
        print(f"phase 4k: {cfg.name} graphed tokens equal eager tokens for "
              f"{len(reqs)} requests ({sum(o.size for o in outs)} tokens); "
              f"{steps} decode steps, each one replay; B2 launches per "
              f"prefill: non-causal {b2['noncausal'] // len(reqs)}, causal "
              f"{b2['causal'] // len(reqs)}; split-kv decode launches per "
              f"step: {b2['decode'] // steps}")
        res = {"cfg": cfg, "counts": counts, "b2": b2, "wall_s": wall,
               "tokens": sum(o.size for o in outs), "init_s": init_s}

        # First-token logits against the plain forward on the same weights.
        plain = VortexServer(cfg, max_cache=max_cache, params=server.params,
                             impl="torch", graphs=False)
        r = reqs[0]
        _, res["logit_rel"] = rel_err(first_logits(server, cfg, r.tokens),
                                      first_logits(plain, cfg, r.tokens))
        torch.cuda.synchronize()
        print(f"phase 4k: {cfg.name} first-token logits of a "
              f"{r.tokens.shape} prompt vs impl=torch: rel="
              f"{res['logit_rel']:.4g} (tolerance {LOGIT_TOL}, bf16)")
        if not res["logit_rel"] <= LOGIT_TOL:
            fail(f"phase 4k: {cfg.name} first-token logits disagree with "
                 f"impl='torch': {res['logit_rel']}")
        del plain

        big = max(reqs, key=lambda q: q.tokens.size)
        bp = server.batch_bucket(big.tokens.shape[0])
        sp = server.seq_bucket(big.tokens.shape[1])
        kv_len = big.tokens.shape[1] + big.max_new - 1
        kvb = server.kv_bucket(sp)
        if kv_len > kvb:
            kvb = server._grown_kv_bucket(kvb, kv_len)
        if cfg.encoder_decoder:
            res["encoder_b2_err"] = encoder_b2_check(dev, server, cfg, bp)
        if cfg.vision_prefix:
            pool0 = server.kv_pool.stats()
            short = Request(tokens=np.random.default_rng(51).integers(
                0, cfg.vocab, (1, C13_PROMPT)).astype(np.int64), max_new=4)
            try:
                server.generate(short)
                fail(f"phase 4k: {cfg.name} served a {C13_PROMPT}-token "
                     f"prompt under its {cfg.vision_prefix}-row prefix")
            except VisionPrefixError as e:
                print(f"phase 4k: C13 {cfg.name} refused a {C13_PROMPT}-"
                      f"token prompt: {e}")
            if server.kv_pool.stats() != pool0:
                fail(f"phase 4k: {cfg.name} the C13 refusal moved the pool: "
                     f"{pool0} -> {server.kv_pool.stats()}")
        res["prefill_ms"], res["decode_ms"] = step_ms(server, big.tokens)
        res["plain_ms"] = plain_encoder_vision_times(dev, cfg, server, bp,
                                                     sp, smi)
        shape = dict(cfg=cfg, engine=server.engine, server=server, bp=bp,
                     sp=sp, kvb=kvb, kv_len=kv_len, counts=counts, b2=b2)
        g = torch.Generator().manual_seed(15)
        if cfg.encoder_decoder:
            rows.append(encoder_row(dev, shape, errs, g))
        # Rows for the decoder's causal prefill and decode: their launches
        # are the engine's per form (the kernel counters sum both prefill
        # forms).
        rows += attention_rows(dev, dict(shape, counts={
            "flash_attention_prefill": b2["causal"],
            "flash_attention_decode": b2["decode"]}), errs, g,
            f", {cfg.name}")
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"phase 4k: {cfg.name} prefill (b={big.tokens.shape[0]}, "
              f"s={big.tokens.shape[1]}) at ({bp}, {sp}): "
              f"{res['prefill_ms']:.3f} ms; one decode step after it: "
              f"{res['decode_ms']:.3f} ms [CUDA events]; peak_gb="
              f"{res['peak_gb']:.2f} on {smi}")
        info[arch] = res
        del server, eager, shape
        free_cuda()
    info["rows"] = rows
    return info


# ---------------------------------------------------------------------------
# Phase 5: timings at the main path's shapes
# ---------------------------------------------------------------------------


def phase_time(dev, gemm_info, serve_info, errs) -> list[dict]:
    from repro_torch.kernels.gemm import vortex_gemm, vortex_gemm_plain

    dt = torch.bfloat16
    g = torch.Generator().manual_seed(2)
    rows = []

    M, N, K = gemm_info["M"], gemm_info["N"], gemm_info["K"]
    bm, bn, bk = gemm_info["blocks"]
    be = gemm_info["backend"]
    a = torch.randn(M, K, generator=g).to(dev, dt)
    b = torch.randn(K, N, generator=g).to(dev, dt)

    def gemm(tma=True):
        return vortex_gemm(a, b, M, block_m=bm, block_n=bn, block_k=bk,
                           backend=be, tma=tma)

    err = check("vortex_gemm at the main path's shape", gemm(),
                vortex_gemm_plain(a, b, M), TOL[dt])
    errs["vortex_gemm"] = max(errs["vortex_gemm"], err)
    bnd, by = bound_ms(2 * (M * K + K * N + M * N), 2 * M * N * K, dt)
    rows.append(timed(
        {
            "name": "vortex_gemm", "route": "cuda",
            "source": "src/repro_torch/csrc/gemm.cu",
            "replaces": "src/repro/kernels/gemm.py:110",
            "launches": gemm_info["launches"],
            "max_abs_err": errs["vortex_gemm"],
            "bound_ms": bnd, "bound_by": by,
            "shape": f"M={M} N={N} K={K} blocks=({bm},{bn},{bk}) {be} bf16",
        },
        ms=gemm,
        plain_ms=lambda: vortex_gemm_plain(a, b, M),
        library_ms=lambda: torch.matmul(a, b),
        cp_async_ms=lambda: gemm(tma=False),
    ))
    if serve_info is None:
        return rows
    rows += attention_rows(dev, serve_info, errs, g, "")
    torch.cuda.synchronize()
    return rows


def attention_rows(dev, serve_info, errs, g, tag: str) -> list[dict]:
    """Rows for prefill and decode attention at the shapes the server gave
    the kernel, at the selected tile and backend.  The bound reads q and
    writes the output over the query heads and reads K and V once over the
    kv heads."""
    import torch.nn.functional as F

    from repro_torch.core.workloads import (
        AttentionWorkload,
        DecodeAttentionWorkload,
    )
    from repro_torch.kernels.attention import (
        flash_attention,
        flash_attention_plain,
    )

    dt = torch.bfloat16
    rows = []
    cfg, server = serve_info["cfg"], serve_info["server"]
    eng = server.engine
    H, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    bp, sp, kvb, kv_len = (serve_info[k] for k in ("bp", "sp", "kvb", "kv_len"))
    counts = serve_info["counts"]
    gqa = hkv != H

    # Prefill: the engine calls the kernel at the bucket shape with
    # kv_len = sp, causal (the whole padded prompt is valid keys).
    sel = eng.kernel_for(AttentionWorkload(seq=None, head_dim=hd)).select(sp)
    m1, _, k1 = sel.strategy.l1
    be = sel.strategy.backend
    q = torch.randn(bp, H, sp, hd, generator=g).to(dev, dt)
    k, v = (torch.randn(bp, hkv, sp, hd, generator=g).to(dev, dt)
            for _ in range(2))

    def pre():
        return flash_attention(q, k, v, sp, block_q=m1, block_k=k1,
                               backend=be)

    err = check(f"flash_attention prefill{tag} at the main path's shape",
                pre(), flash_attention_plain(q, k, v, sp), ATTN_TOL[dt])
    errs["flash_attention_prefill"] = max(errs["flash_attention_prefill"], err)
    flops = 4.0 * hd * bp * H * sp * (sp + 1) / 2  # causal keys per row
    nbytes = 2 * (2 * bp * H * sp * hd + 2 * bp * hkv * sp * hd)
    bnd, by = bound_ms(nbytes, flops, dt)
    rows.append(timed(
        {
            "name": f"flash_attention (prefill{tag})", "route": "cuda",
            "source": "src/repro_torch/csrc/attention_tc.cu"
            if (be, dt) == ("tensor_core", torch.bfloat16)
            else "src/repro_torch/csrc/attention.cu",
            "replaces": "src/repro/kernels/attention.py:125",
            "launches": counts["flash_attention_prefill"],
            "max_abs_err": errs["flash_attention_prefill"],
            "bound_ms": bnd, "bound_by": by,
            "shape": f"{cfg.name} q=({bp},{H},{sp},{hd}) kv heads {hkv} "
                     f"kv_len={sp} blocks=({m1},{k1}) {be} causal bf16",
        },
        ms=pre,
        plain_ms=lambda: flash_attention_plain(q, k, v, sp),
        library_ms=lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=gqa),
    ))

    # Decode: one query row against the kv-bucket cache, kv_len valid rows.
    sel = eng.kernel_for(DecodeAttentionWorkload(seq=None, head_dim=hd)) \
        .select(kvb)
    k1 = sel.strategy.l1[2]
    be = sel.strategy.backend
    q = torch.randn(bp, H, 1, hd, generator=g).to(dev, dt)
    k, v = (torch.randn(bp, hkv, kvb, hd, generator=g).to(dev, dt)
            for _ in range(2))
    mask = (torch.arange(kvb, device=dev) < kv_len)[None, :]

    def dec():
        return flash_attention(q, k, v, kv_len, kv_len - 1, block_q=1,
                               block_k=k1, backend=be, causal=False)

    def dec_plain():
        return flash_attention_plain(q, k, v, kv_len, kv_len - 1,
                                     causal=False)

    err = check(f"flash_attention decode{tag} at the main path's shape",
                dec(), dec_plain(), ATTN_TOL[dt])
    errs["flash_attention_decode"] = max(errs["flash_attention_decode"], err)
    nbytes = 2 * (2 * bp * H * hd + 2 * bp * hkv * kv_len * hd)
    bnd, by = bound_ms(nbytes, 4.0 * hd * bp * H * kv_len, dt)
    rows.append(timed(
        {
            "name": f"flash_attention (decode{tag})", "route": "cuda",
            "source": "src/repro_torch/csrc/attention_decode.cu",
            "replaces": "src/repro/kernels/attention.py:125",
            "launches": counts["flash_attention_decode"],
            "max_abs_err": errs["flash_attention_decode"],
            "bound_ms": bnd, "bound_by": by,
            "shape": f"{cfg.name} q=({bp},{H},1,{hd}) kv heads {hkv} "
                     f"cache={kvb} kv_len={kv_len} block_k={k1} {be} bf16",
        },
        ms=dec,
        plain_ms=dec_plain,
        library_ms=lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=gqa),
    ))
    torch.cuda.synchronize()
    return rows


def flex_library(q, k, v, cap: float, mask_mod, batch, ref, what: str):
    """The library call for an attention with tanh softcap: one compiled
    ``flex_attention`` with ``cap * tanh(score / cap)`` as its
    ``score_mod``, ``mask_mod`` as its block mask (over ``batch`` rows, or
    shared when None) and ``enable_gqa``, at the default 1/sqrt(d) scale.
    It is held against ``ref`` (the plain version on the same inputs) at
    the attention tolerance, so its time is of the same function; returns
    the call."""
    from torch.nn.attention.flex_attention import (
        create_block_mask,
        flex_attention,
    )

    def softcap(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    block_mask = create_block_mask(mask_mod, batch, None, q.shape[2],
                                   k.shape[2], device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)

    def call():
        return flex(q, k, v, score_mod=softcap, block_mask=block_mask,
                    enable_gqa=True)

    check(f"flex_attention (library) for {what}", call(), ref,
          ATTN_TOL[q.dtype])
    return call


def dense_attention_rows(g2: dict, dense: dict, errs: dict) -> list[dict]:
    """Rows 2e-2g: gemma2's prefill on a local layer at the long prompt's
    shape (d = 256, window 4096, softcap 50), gemma2's mixed-progress decode
    at the compared step of phase 4c (per-row kv_len of its 8 rows), and
    h2o-danube3's prefill at d = 120 at its largest request's shape.  Bounds
    count the keys each row's window and kv_len leave it.  gemma2's library
    time is a compiled ``flex_attention`` (:func:`flex_library`)."""
    import torch.nn.functional as F

    from repro_torch import vortex
    from repro_torch.core.workloads import (
        AttentionWorkload,
        DecodeAttentionWorkload,
    )
    from repro_torch.kernels.attention import (
        flash_attention,
        flash_attention_plain,
    )

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator().manual_seed(7)
    eng = vortex.Engine()  # the defaults: H100 lattice, CUDA kernels, card
    rows = []
    cfg = g2["cfg"]
    H, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    W, cap = cfg.pattern[0].window, cfg.attn_softcap

    # 2e: the long prompt's prefill on a local layer.
    sp = g2["long_sp"]
    sel = eng.kernel_for(AttentionWorkload(
        seq=None, head_dim=hd, window=W, softcap=cap)).select(sp)
    m1, _, k1 = sel.strategy.l1
    be = sel.strategy.backend
    q = torch.randn(1, H, sp, hd, generator=g).to(dev, dt)
    k, v = (torch.randn(1, hkv, sp, hd, generator=g).to(dev, dt)
            for _ in range(2))

    def pre():
        return flash_attention(q, k, v, sp, block_q=m1, block_k=k1,
                               backend=be, window=W, softcap=cap)

    def pre_plain():
        return flash_attention_plain(q, k, v, sp, window=W, softcap=cap)

    ref = pre_plain()
    err = check("flash_attention prefill, gemma2 local layer at the main "
                "path's shape", pre(), ref, ATTN_TOL[dt])
    lib = flex_library(
        q, k, v, cap, lambda b, h, qi, ki: (qi >= ki) & (qi - ki < W), None,
        ref, "gemma2 local-layer prefill")
    del ref
    errs["flash_attention_prefill"] = max(errs["flash_attention_prefill"], err)
    keys = sum(min(i + 1, W) for i in range(sp))
    bnd, by = bound_ms(2 * (2 * H * sp * hd + 2 * hkv * sp * hd),
                       4.0 * hd * H * keys, dt)
    row = timed(
        {
            "name": "flash_attention (prefill, gemma2 local d=256)",
            "route": "cuda", "source": "src/repro_torch/csrc/attention_tc.cu",
            "replaces": "src/repro/kernels/attention.py:125",
            "launches": g2["prefill_launches"], "max_abs_err": err,
            "bound_ms": bnd, "bound_by": by,
            "shape": f"gemma2-9b q=(1,{H},{sp},{hd}) kv heads {hkv} "
                     f"kv_len={sp} window={W} softcap={cap} "
                     f"blocks=({m1},{k1}) {be} causal bf16; library: "
                     "compiled flex_attention",
        },
        ms=pre, plain_ms=pre_plain, library_ms=lib,
    )
    rows.append(row)
    del q, k, v
    free_cuda()

    # The window slice's gather copy at phase 4d's decode (one row at the
    # long prompt's position, the cache at its kv bucket): per local layer
    # and per decode step.
    from repro_torch.models.layers import _window_slice

    kvb4d = g2["d"]["step_kvb"]
    kc, vc = (torch.randn(1, hkv, kvb4d, hd, generator=g).to(dev, dt)
              for _ in range(2))
    pos = torch.tensor([LONG_PROMPT], dtype=torch.int32, device=dev)
    gather_ms = device_ms(lambda: _window_slice(kc, vc, pos, W))
    local = sum(1 for sp_ in cfg.pattern if sp_.window) * cfg.n_groups
    print(f"window slice gather at phase 4d's shape (cache (1,{hkv},{kvb4d},"
          f"{hd}) bf16, {W} rows of K and V): {gather_ms:.4f} ms a local "
          f"layer, {gather_ms * local:.4f} ms a decode step ({local} local "
          f"layers; torch.profiler device time) on {card_name()}")
    del kc, vc
    free_cuda()

    # 2f: the compared mixed-progress decode step of phase 4c.
    kv_len = torch.tensor(g2["c"]["step_kv_len"], dtype=torch.int32,
                          device=dev)
    kvb, b = g2["c"]["step_kvb"], kv_len.numel()
    sel = eng.kernel_for(DecodeAttentionWorkload(
        seq=None, head_dim=hd, window=W, softcap=cap)).select(kvb)
    k1 = sel.strategy.l1[2]
    be = sel.strategy.backend
    q = torch.randn(b, H, 1, hd, generator=g).to(dev, dt)
    k, v = (torch.randn(b, hkv, kvb, hd, generator=g).to(dev, dt)
            for _ in range(2))

    def dec():
        return flash_attention(q, k, v, kv_len, kv_len - 1, block_q=1,
                               block_k=k1, backend=be, causal=False,
                               window=W, softcap=cap)

    def dec_plain():
        return flash_attention_plain(q, k, v, kv_len, kv_len - 1,
                                     causal=False, window=W, softcap=cap)

    ref = dec_plain()
    err = check("flash_attention decode, gemma2 mixed-progress step at the "
                "main path's shape", dec(), ref, ATTN_TOL[dt])

    def in_window(b_, h, qi, ki):  # key ki of row b_'s query at kv_len - 1
        last = kv_len[b_] - 1
        return (ki <= last) & (last - ki < W)

    lib = flex_library(q, k, v, cap, in_window, b, ref,
                       "gemma2 mixed-progress decode")
    errs["flash_attention_decode"] = max(errs["flash_attention_decode"], err)
    keys = sum(min(n, W) for n in g2["c"]["step_kv_len"])
    bnd, by = bound_ms(2 * (2 * b * H * hd + 2 * hkv * keys * hd),
                       4.0 * hd * H * keys, dt)
    row = timed(
        {
            "name": "flash_attention (decode, gemma2 per-row kv_len)",
            "route": "cuda",
            "source": "src/repro_torch/csrc/attention_decode.cu",
            "replaces": "src/repro/kernels/attention.py:125",
            "launches": g2["decode_launches"], "max_abs_err": err,
            "bound_ms": bnd, "bound_by": by,
            "shape": f"gemma2-9b q=({b},{H},1,{hd}) kv heads {hkv} "
                     f"cache={kvb} kv_len={g2['c']['step_kv_len']} "
                     f"window={W} softcap={cap} block_k={k1} {be} bf16; "
                     "library: compiled flex_attention",
        },
        ms=dec, plain_ms=dec_plain, library_ms=lib,
    )
    rows.append(row)
    del q, k, v
    free_cuda()

    # 2g: h2o-danube3's prefill at head_dim 120.
    dn = dense["h2o-danube-3-4b"]
    cfg = dn["cfg"]
    H, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    W = cfg.pattern[0].window
    bp, sp = dn["bp"], dn["sp"]
    if sp > W:
        fail(f"row 2g: seq bucket {sp} past the window {W}: SDPA would not "
             "compute the same function")
    sel = eng.kernel_for(AttentionWorkload(
        seq=None, head_dim=hd, window=W)).select(sp)
    m1, _, k1 = sel.strategy.l1
    be = sel.strategy.backend
    q = torch.randn(bp, H, sp, hd, generator=g).to(dev, dt)
    k, v = (torch.randn(bp, hkv, sp, hd, generator=g).to(dev, dt)
            for _ in range(2))

    def dpre():
        return flash_attention(q, k, v, sp, block_q=m1, block_k=k1,
                               backend=be, window=W)

    err = check("flash_attention prefill, danube d=120 at the main path's "
                "shape", dpre(), flash_attention_plain(q, k, v, sp, window=W),
                ATTN_TOL[dt])
    errs["flash_attention_prefill"] = max(errs["flash_attention_prefill"], err)
    bnd, by = bound_ms(2 * (2 * bp * H * sp * hd + 2 * bp * hkv * sp * hd),
                       4.0 * hd * bp * H * sp * (sp + 1) / 2, dt)
    rows.append(timed(
        {
            "name": "flash_attention (prefill, danube d=120)", "route": "cuda",
            "source": "src/repro_torch/csrc/attention_tc.cu",
            "replaces": "src/repro/kernels/attention.py:125",
            "launches": dn["counts"]["flash_attention_prefill"],
            "max_abs_err": err, "bound_ms": bnd, "bound_by": by,
            "shape": f"h2o-danube-3-4b q=({bp},{H},{sp},{hd}) kv heads {hkv} "
                     f"kv_len={sp} window={W} (no key outside it) "
                     f"blocks=({m1},{k1}) {be} causal bf16",
        },
        ms=dpre,
        plain_ms=lambda: flash_attention_plain(q, k, v, sp, window=W),
        library_ms=lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True),
    ))
    torch.cuda.synchronize()
    return rows


def routed_counts(g, bp: int, s: int, E: int, k: int, C: int) -> list[int]:
    """Per-group row counts of one MoE layer's dispatch for ``bp``
    sequences of ``s`` tokens, each token choosing ``k`` distinct experts
    uniformly (as the seeded router does), capped at capacity ``C``;
    expert-major, group = e * bp + sequence."""
    counts = [0] * (E * bp)
    for seq in range(bp):
        for _ in range(s):
            for e in torch.randperm(E, generator=g)[:k].tolist():
                counts[e * bp + seq] += 1
    return [min(c, C) for c in counts]


def grouped_rows(dev, moe_info, errs, g, tag: str = "", gw=None) -> list:
    """Rows for the grouped GEMM's prefill and decode forms at the shapes
    an MoE server gave the kernel (its first projection: the slabs at
    their true capacity C, as the engine launches the bucket's kernel on
    them), each held against the plain version first.  The routing counts
    draw from ``g``, the operands from ``gw`` (default ``g``; a generator
    on the card draws a large expert stack there)."""
    from repro_torch.core.workloads import GroupedGemmWorkload
    from repro_torch.kernels.grouped_gemm import (
        stacked_grid,
        vortex_grouped_gemm,
        vortex_grouped_gemm_plain,
    )
    from repro_torch.models.layers import moe_capacity

    gw = g if gw is None else gw
    dt = torch.bfloat16
    rows = []
    cfg, engine = moe_info["cfg"], moe_info["engine"]
    E, k, fe, d = (cfg.moe.num_experts, cfg.moe.top_k, cfg.moe.d_ff_expert,
                   cfg.d_model)
    bp, sp = moe_info["bp"], moe_info["sp"]
    G, r = E * bp, bp
    # The first projection (w_in: K = d_model, N = d_ff_expert); w_gate is
    # the same call and w_out its transpose in shape.
    kern = engine.kernel_for(
        GroupedGemmWorkload(C=None, G=G, E=E, N=fe, K=d))
    w = (torch.randn(E, d, fe, generator=gw, device=gw.device)
         * E ** -0.5).to(dev, dt)
    for form, s in (("prefill", sp), ("decode", 1)):
        C = moe_capacity(cfg, s)
        sel = kern.select(C)
        cp = sel.padded_m
        bm, bn, bk = sel.strategy.l1
        be = sel.strategy.backend
        counts = routed_counts(g, bp, s, E, k, C)
        x = torch.randn(G, C, d, generator=gw, device=gw.device).to(dev, dt)
        for i, n in enumerate(counts):
            x[i, n:] = float("nan")  # routing pad
        cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
        rows_valid = torch.arange(C, device=dev)[None, :] < cnt[:, None]
        xm = torch.where(rows_valid[..., None], x, 0.0).reshape(E, r * C, d)
        stacked = stacked_grid(G, E, C, bm).stacked if be == "tensor_core" \
            else False

        def kernel_call():
            return vortex_grouped_gemm(x, w, cnt, block_m=bm, block_n=bn,
                                       block_k=bk, backend=be)

        err = check(f"vortex_grouped_gemm {form}{tag} at the main path's "
                    f"shape", kernel_call(),
                    vortex_grouped_gemm_plain(x, w, cnt), TOL[dt])
        errs["vortex_grouped_gemm"] = max(errs["vortex_grouped_gemm"], err)
        valid = sum(counts)
        used = sum(1 for e in range(E) if any(counts[e * r:(e + 1) * r]))
        nbytes = 2 * (valid * d + used * d * fe + G * C * fe) + 4 * G
        bnd, by = bound_ms(nbytes, 2.0 * valid * d * fe, dt)
        rows.append(timed(
            {
                "name": f"vortex_grouped_gemm ({form}{tag})", "route": "cuda",
                "source": "src/repro_torch/csrc/grouped_gemm.cu",
                "replaces": "src/repro/kernels/grouped_gemm.py:95",
                "launches": moe_info["per_form"][form],
                "max_abs_err": errs["vortex_grouped_gemm"],
                "bound_ms": bnd, "bound_by": by,
                "shape": f"{cfg.name} x=({G},{C},{d}) in a {cp}-row "
                         f"bucket w=({E},{d},{fe}) rows={valid} "
                         f"experts={used} blocks=({bm},{bn},{bk}) {be} "
                         f"stacked={stacked} bf16",
            },
            ms=kernel_call,
            plain_ms=lambda: vortex_grouped_gemm_plain(x, w, cnt),
            library_ms=lambda: torch.bmm(xm, w),
        ))
    torch.cuda.synchronize()
    return rows


def phase_time_moe_conv(dev, moe_info, conv_info, errs) -> list[dict]:
    """Rows 3 (grouped GEMM, prefill and decode forms, at the shapes the
    granite server gave the kernel) and 4 (conv2d at conv2_x, b = 8)."""
    import torch.nn.functional as F

    from repro_torch.kernels.conv import (
        conv_weight_matrix,
        im2col,
        vortex_conv2d,
    )
    from repro_torch.kernels.gemm import vortex_gemm, vortex_gemm_plain

    dt = torch.bfloat16
    g = torch.Generator().manual_seed(4)
    rows = [] if moe_info is None else grouped_rows(
        dev, dict(moe_info, engine=moe_info["server"].engine), errs, g)

    name, b, hw = conv_info["name"], conv_info["b"], conv_info["hw"]
    cin, cout, stride = conv_info["cin"], conv_info["cout"], conv_info["stride"]
    bm, bn, bk = conv_info["blocks"]
    be = conv_info["backend"]
    M = conv_info["M"]
    x = torch.randn(b, hw, hw, cin, generator=g).to(dev, dt)
    w = (torch.randn(3, 3, cin, cout, generator=g) * (9 * cin) ** -0.5).to(
        dev, dt)
    x_lib = x.permute(0, 3, 1, 2)  # NCHW view of NHWC: channels_last
    w_lib = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def conv():
        return vortex_conv2d(x, w, stride=stride, block_m=bm, block_n=bn,
                             block_k=bk, backend=be)

    def conv_plain():
        cols, (b_, ho, wo) = im2col(x, 3, 3, stride)
        return vortex_gemm_plain(cols, conv_weight_matrix(w)).reshape(
            b_, ho, wo, cout)

    def conv_cp_async():
        cols, (b_, ho, wo) = im2col(x, 3, 3, stride)
        return vortex_gemm(cols, conv_weight_matrix(w), block_m=bm,
                           block_n=bn, block_k=bk, backend=be,
                           tma=False).reshape(b_, ho, wo, cout)

    err = check(f"vortex_conv2d {name} b={b} at the main path's shape",
                conv(), conv_plain(), TOL[dt])
    nbytes = 2 * (b * hw * hw * cin + 9 * cin * cout + M * cout)
    bnd, by = bound_ms(nbytes, 2.0 * M * cout * 9 * cin, dt)
    rows.append(timed(
        {
            "name": "vortex_conv2d", "route": "cuda",
            "source": "src/repro_torch/kernels/conv.py",
            "replaces": "src/repro/kernels/conv.py:36",
            "launches": conv_info["launches"],
            "max_abs_err": err,
            "bound_ms": bnd, "bound_by": by,
            "shape": f"ResNet-50 {name} x=({b},{hw},{hw},{cin}) 3x3 "
                     f"{cin}->{cout} stride {stride}: im2col + gemm.cu at "
                     f"M={M} N={cout} K={9 * cin} blocks=({bm},{bn},{bk}) "
                     f"{be} bf16",
        },
        ms=conv,
        plain_ms=conv_plain,
        library_ms=lambda: F.conv2d(x_lib, w_lib, stride=stride),
        cp_async_ms=conv_cp_async,
    ))
    torch.cuda.synchronize()
    return rows


# The staging copy's cases: (source shapes, buffer shapes, dtype).  The hot
# path's attention (three operands, bf16), its GEMM (one), and float32
# planes of 84 bytes (the byte path: not 16-byte aligned).
STAGE_CASES = (
    (((2, 8, 255, 64), (2, 4, 255, 64), (2, 4, 255, 64)),
     ((2, 8, 256, 64), (2, 4, 256, 64), (2, 4, 256, 64)), torch.bfloat16),
    (((383, 2304),), ((384, 2304),), torch.bfloat16),
    (((5, 3, 7), (1, 2, 2)), ((5, 8, 7), (4, 2, 2)), torch.float32),
)


def stage_operands(dev, case, g):
    """NaN-poisoned buffers and seeded sources of one staging case."""
    shapes, buf_shapes, dt = case
    bufs = [torch.full(s, float("nan"), dtype=dt, device=dev)
            for s in buf_shapes]
    srcs = [torch.randn(s, generator=g).to(dev, dt) for s in shapes]
    return bufs, srcs


def phase_stage(dev, kernels, errs: dict) -> None:
    """Phase 2, the engine's staging copy: one launch stages every operand
    into its buffer's leading corner, bit-identical to one ``copy_`` per
    operand, and the pad tails keep their NaN."""
    from repro_torch.kernels.stage import stage_copy, stage_copy_plain

    g = torch.Generator().manual_seed(11)
    for case in STAGE_CASES:
        bufs, srcs = stage_operands(dev, case, g)
        want = [b.clone() for b in bufs]
        stage_copy_plain(want, srcs)
        n0 = kernels.launch_counts()["stage_copy"]
        stage_copy(bufs, srcs)
        torch.cuda.synchronize()
        if kernels.launch_counts()["stage_copy"] - n0 != 1:
            fail("stage_copy: expected one launch for all operands")
        for b, w in zip(bufs, want):
            if not torch.equal(b.nan_to_num(7.0), w.nan_to_num(7.0)):
                fail(f"stage_copy {case[0]}: differs from one copy_ per "
                     f"operand (or wrote a pad tail)")
        print(f"stage_copy {[tuple(x) for x in case[0]]} {case[2]}: "
              f"bit-identical to copy_, pad tails untouched")
    errs["stage_copy"] = 0.0


def stage_row(dev, launches: int, errs: dict) -> dict:
    """Row 5: the staging copy at the shape the hot path's unaligned
    attention call staged before its launch read the operands in place
    (q, k, v into their 256-row buckets in one launch).  Its launches are
    phase 4h's: the engine paths that still stage on the card (a restaged
    handle, a lazy output); phase 6 prints its own."""
    from repro_torch.kernels.stage import StagePlan, stage_copy_plain

    g = torch.Generator().manual_seed(12)
    case = STAGE_CASES[0]
    bufs, srcs = stage_operands(dev, case, g)
    plan = StagePlan(bufs, case[0])
    views = [b[tuple(slice(0, n) for n in s)] for b, s in zip(bufs, case[0])]
    nbytes = 2 * sum(x.numel() * x.element_size() for x in srcs)
    bnd, by = bound_ms(nbytes, 0.0, case[2])
    return timed(
        {
            "name": "stage_copy", "route": "cuda",
            "source": "src/repro_torch/csrc/stage.cu",
            "replaces": "src/repro/core/engine.py:137 (_stage_into, not a "
                        "Pallas kernel)",
            "launches": launches, "max_abs_err": errs["stage_copy"],
            "bound_ms": bnd, "bound_by": by,
            "shape": "q (2,8,255,64), k and v (2,4,255,64) into 256-row "
                     "buckets, bf16, one launch",
        },
        ms=lambda: plan.run(srcs),
        plain_ms=lambda: stage_copy_plain(bufs, srcs),
        library_ms=lambda: torch._foreach_copy_(views, srcs),
    )


# ---------------------------------------------------------------------------
# Phase 6: the benchmark suite's serving snapshot (benchmarks_torch)
# ---------------------------------------------------------------------------

PHASE6_KERNELS = ("vortex_gemm", "flash_attention_prefill",
                  "flash_attention_decode", "vortex_grouped_gemm")
# The reference's boundary copies per unaligned hot-path call: one per
# dynamic operand and one for the output (q, k and v for attention).
HOT_PATH_BOUNDARIES = {"gemm": 2.0, "attention": 4.0, "conv2d": 2.0}


def check_serving_payload(p: dict) -> None:
    """Fails unless the snapshot keeps the deterministic contracts: one
    engine launch and one kernel launch per engine call, 0 padded calls,
    one decode step (of n_layers decode-attention launches) per token and
    per batched step, one grouped launch per MoE projection, the kv pool's
    leases back to 0, and MoE within the grouped GEMM's tolerance."""
    for kind, h in p["hot_path"].items():
        if h["launches_per_call"] != 1.0 or h["kernel_launches_per_call"] != 1.0:
            fail(f"phase 6 hot_path/{kind}: {h['launches_per_call']} engine and "
                 f"{h['kernel_launches_per_call']} kernel launches per call")
        if h["padded_calls"] != 0:
            fail(f"phase 6 hot_path/{kind}: {h['padded_calls']} padded calls")
        if (h["stage_launches_per_unaligned_call"] != 0.0
                or h["copies_per_unaligned_call"] != 0.0
                or h["folded_per_unaligned_call"] != HOT_PATH_BOUNDARIES[kind]):
            fail(f"phase 6 hot_path/{kind}: "
                 f"{h['stage_launches_per_unaligned_call']} staging launches, "
                 f"{h['copies_per_unaligned_call']} copies and "
                 f"{h['folded_per_unaligned_call']} folded boundaries per "
                 f"unaligned call (expected 0, 0 and "
                 f"{HOT_PATH_BOUNDARIES[kind]})")
    dec, cb, moe = p["decode"], p["continuous_batching"], p["moe"]
    layers = dec["n_layers"]
    if (dec["launches_per_token"] != 1.0 or dec["padded_calls"] != 0
            or dec["engine_padded_calls"] != 0):
        fail(f"phase 6 decode: {dec['launches_per_token']} steps per token, "
             f"{dec['padded_calls']} padded calls")
    per_tok = dec["kernel_launches_per_token"].get("flash_attention_decode")
    if per_tok != layers:
        fail(f"phase 6 decode: {per_tok} decode-attention launches per token, "
             f"expected {layers}")
    if cb["launches_per_batched_step"] != 1.0 or cb["padded_calls"] != 0:
        fail(f"phase 6 continuous_batching: {cb['launches_per_batched_step']} "
             f"steps per batched step, {cb['padded_calls']} padded calls")
    for c, r in cb["concurrency"].items():
        if r["kernel_launches_per_batched_step"] != layers:
            fail(f"phase 6 continuous_batching@{c}: "
                 f"{r['kernel_launches_per_batched_step']} decode-attention "
                 f"launches per batched step, expected {layers}")
    if cb["kv_pool"]["leases_active"] != 0:
        fail(f"phase 6: kv pool leases left active: {cb['kv_pool']}")
    for name, r in (("decode", dec), ("continuous_batching", cb)):
        if r["prefill_graph_captures"] or not r["prefill_graph_replays"]:
            fail(f"phase 6 {name}: {r['prefill_graph_captures']} prefill "
                 f"graph captures and {r['prefill_graph_replays']} replays "
                 f"in the timed windows")
    pc = p["prefill_chain"]
    layers = pc["blocks_per_prefill"]
    want = {"vortex_gemm": 6 * layers + 1,
            "vortex_gemm.tensor_core": 6 * layers + 1,
            "flash_attention_prefill": layers,
            "flash_attention_prefill.tensor_core": layers}
    if not (pc["chain_aligned"] and pc["boundary_copies_per_block"] == 0
            and pc["forwarded_per_prefill"] >= layers
            and pc["bit_identical_to_eager"]
            and fold_feeds(pc["kernel_launches_per_prefill"],
                           "phase 6 prefill_chain") == want):
        fail(f"phase 6 prefill_chain: {pc}")
    for name, r in (("decode", dec), ("continuous_batching", cb)):
        if not (r["graphs"] and r["decode_graph_captures"] == 0
                and r["decode_graph_replays"] == r["timed_steps"]):
            fail(f"phase 6 {name}: {r['decode_graph_captures']} captures and "
                 f"{r['decode_graph_replays']} graph replays for "
                 f"{r['timed_steps']} decode steps in the timed windows "
                 f"(graphs {r['graphs']})")
    if (moe["launches_per_moe_layer"] != 1.0
            or moe["kernel_launches_per_moe_layer"] != 1.0
            or moe["padded_calls"] != 0):
        fail(f"phase 6 moe: {moe['launches_per_moe_layer']} engine and "
             f"{moe['kernel_launches_per_moe_layer']} grouped launches per "
             f"projection, {moe['padded_calls']} padded calls")
    if not moe["within_tolerance"]:
        fail(f"phase 6 moe: engine vs dense relative diff "
             f"{moe['max_rel_diff_vs_dense']:.3g} > {moe['tolerance']:.3g}")


def phase_bench(kernels, smi: str) -> dict:
    """Phase 6: ``serving_payload(smoke=False)`` on the card."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks_torch.bench_workloads import serving_payload
    except ImportError as e:
        fail(f"benchmarks_torch is not beside this script: {e}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    p = serving_payload(False)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    check_serving_payload(p)
    missing = [k for k in PHASE6_KERNELS if counts[k] == 0]
    if missing:
        fail(f"phase 6 launched no {', '.join(missing)}")
    for kind, d in p["dispatch"].items():
        print(f"phase 6 dispatch/{kind}: table {d['table_us']:.3f} us vs "
              f"argmin {d['argmin_us']:.3f} us per select "
              f"({d['speedup']:.1f}x) on {smi}")
    for kind, h in p["hot_path"].items():
        print(f"phase 6 hot_path/{kind}: aligned {h['aligned_us']:.3f} us "
              f"(extent {h['aligned_extent']}) unaligned "
              f"{h['unaligned_us']:.3f} us (extent {h['unaligned_extent']}) "
              f"ratio {h['unaligned_over_aligned']:.4f} after "
              f"{h['gate_attempts']} attempts, {h['kernel_launches']} "
              f"[host wall-clock, synchronized, bf16] on {smi}")
    dec, cb, moe = p["decode"], p["continuous_batching"], p["moe"]
    print(f"phase 6 decode: {dec['arch']} {dec['n_layers']} layers, "
          f"{dec['tokens']} tokens, {dec['decode_us_per_token']:.1f} us/token "
          f"({dec['decode_graph_replays']} graph replays, "
          f"{dec['decode_graph_captures']} captures in the timed window), "
          f"kernel launches/token {dec['kernel_launches_per_token']}, "
          f"growth copies {dec['growth_copies']} over "
          f"{dec['bucket_transitions']} bucket transitions on {smi}")
    conc = ", ".join(
        f"@{c} {r['tokens_per_s']:.1f} tok/s over {r['batched_steps']} steps"
        for c, r in cb["concurrency"].items())
    print(f"phase 6 continuous_batching: serial "
          f"{cb['serial_tokens_per_s']:.1f} tok/s, {conc}, speedup_at_16 "
          f"{cb['speedup_at_16']:.3f} ({cb['decode_graph_replays']} graph "
          f"replays, {cb['decode_graph_captures']} captures for "
          f"{cb['timed_steps']} timed decode steps) on {smi}")
    pc = p["prefill_chain"]
    print(f"phase 6 prefill_chain: {pc['arch']} (b={pc['batch_bucket']}, "
          f"s={pc['prompt_len']}) at seq bucket {pc['seq_bucket']}: chained "
          f"{pc['us_per_prefill']:.1f} us, aot graphed "
          f"{pc['aot_graphed_us_per_prefill']:.1f} us, aot eager "
          f"{pc['aot_eager_us_per_prefill']:.1f} us a prefill [host "
          f"wall-clock, synchronized, bf16]; "
          f"{pc['boundary_copies_per_block']} copies/block, "
          f"{pc['forwarded_per_prefill']} forwarded, kernel launches "
          f"{pc['kernel_launches_per_prefill']}, bit_identical_to_eager "
          f"{pc['bit_identical_to_eager']} on {smi}")
    print(f"phase 6 prefill graphs in the timed windows: decode "
          f"{dec['prefill_graph_replays']} replays / "
          f"{dec['prefill_graph_captures']} captures, continuous_batching "
          f"{cb['prefill_graph_replays']} / {cb['prefill_graph_captures']}")
    print(f"phase 6 moe: {moe['experts']} experts top-{moe['top_k']} "
          f"d_model {moe['d_model']} d_ff_expert {moe['d_ff_expert']}, "
          f"{moe['tokens']} tokens: engine {moe['engine_us_per_layer']:.1f} "
          f"us/layer vs dense {moe['dense_us_per_layer']:.1f} us/layer, "
          f"max rel diff {moe['max_rel_diff_vs_dense']:.3g} (tolerance "
          f"{moe['tolerance']:.3g}), bit_identical "
          f"{moe['bit_identical_to_dense']}, dropped_frac "
          f"{moe['dropped_frac']:.4f} on {smi}")
    totals = {k: counts[k] for k in PHASE6_KERNELS + ("stage_copy",)}
    print(f"phase 6: serving_payload(smoke=False) in {wall:.1f}s, kernel "
          f"launches {totals}")
    return {"launches": totals, "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 6b: background calibration (core/calibrate.py) on the card
# ---------------------------------------------------------------------------

CALIB_KINDS = ("gemm", "conv2d", "grouped_gemm")
# The kernel each calibrated kind's executables launch.
CALIB_FAMILY = {"gemm": "vortex_gemm", "conv2d": "vortex_gemm",
                "grouped_gemm": "vortex_grouped_gemm"}
ATTN_SKIP = "exec-specialized (needs representative args)"
GRANITE_E, GRANITE_K, GRANITE_FE, GRANITE_D = 32, 8, 512, 1024


def calib_engine(dev, cache: str, seed: int):
    """An engine calibrating on idle into ``cache`` that has served the
    main path's shapes once, bf16: the gemm at N = K = 768 (phase 3), the
    conv at ResNet-50's conv2_x (phase 3b), the grouped GEMM at granite's
    expert widths (8 sequences of 64 tokens routed top-8 over 32 experts,
    capacity 20: row 3a's call) and prefill attention at paper-gpt2's shape
    (phase 4)."""
    from repro_torch import vortex

    g = torch.Generator().manual_seed(seed)
    dt = torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dt)

    eng = vortex.Engine(calibration="on-idle", calibration_cache_dir=cache)
    _, hw, cin, cout, stride = RESNET_CONVS[0]
    E, k, fe, d = GRANITE_E, GRANITE_K, GRANITE_FE, GRANITE_D
    counts = routed_counts(g, 8, 64, E, k, 20)
    eng.dispatch("gemm", rnd(97, 768), rnd(768, 768))
    eng.dispatch("conv2d", rnd(1, hw, hw, cin),
                 rnd(3, 3, cin, cout, scale=(9 * cin) ** -0.5), stride=stride)
    eng.dispatch("grouped_gemm", rnd(E * 8, 20, d),
                 rnd(E, d, fe, scale=E ** -0.5),
                 torch.tensor(counts, dtype=torch.int32, device=dev))
    eng.dispatch("attention", rnd(8, 12, 64, 64), rnd(8, 12, 64, 64),
                 rnd(8, 12, 64, 64))
    return eng


def calib_after_swap(dev, eng, kind: str, m: int, g) -> tuple:
    """One engine call of ``kind`` at extent ``m`` and its plain version."""
    from repro_torch.kernels.gemm import vortex_gemm_plain
    from repro_torch.kernels.grouped_gemm import vortex_grouped_gemm_plain

    dt = torch.bfloat16
    if kind == "gemm":
        a = torch.randn(m, 768, generator=g).to(dev, dt)
        b = torch.randn(768, 768, generator=g).to(dev, dt)
        return eng.dispatch("gemm", a, b), vortex_gemm_plain(a, b)
    if kind == "conv2d":
        # 3x3 inputs under the 3x3 kernel: one output pixel per image, so
        # the GEMM's extent is the batch, m.
        cin = cout = RESNET_CONVS[0][2]
        x = torch.randn(m, 3, 3, cin, generator=g).to(dev, dt)
        w = (torch.randn(3, 3, cin, cout, generator=g)
             * (9 * cin) ** -0.5).to(dev, dt)
        ref = vortex_gemm_plain(x.reshape(m, 9 * cin), w.reshape(9 * cin,
                                                                  cout))
        return eng.dispatch("conv2d", x, w), ref.reshape(m, 1, 1, cout)
    E, d, fe = GRANITE_E, GRANITE_D, GRANITE_FE
    x = torch.randn(E * 8, m, d, generator=g).to(dev, dt)
    w = (torch.randn(E, d, fe, generator=g) * E ** -0.5).to(dev, dt)
    cnt = torch.randint(0, m + 1, (E * 8,), generator=g,
                        dtype=torch.int32).to(dev)
    return (eng.dispatch("grouped_gemm", x, w, cnt),
            vortex_grouped_gemm_plain(x, w, cnt))


def tile(sel) -> str:
    return f"{sel.strategy.l1} {sel.backend}"


def backend_share(table) -> dict:
    """Extents of [1, table.m_max] each backend serves in ``table``."""
    ends = table.starts[1:] + [table.m_max + 1]
    out: dict[str, int] = {}
    for start, end, e in zip(table.starts, ends, table.entries):
        out[e.backend] = out.get(e.backend, 0) + end - start
    return out


def phase_calibration(dev, kernels, smi: str) -> dict:
    """Phase 6b, first half: ``run_calibration`` over an engine that served
    the main path's shapes; then a second engine on the same cache
    directory loads every table with no measurement."""
    import tempfile

    from repro_torch.launch.calibration import run_calibration

    g = torch.Generator().manual_seed(9)
    dt = torch.bfloat16
    with tempfile.TemporaryDirectory(prefix="vortex-calibration-") as cache:
        eng = calib_engine(dev, cache, 8)
        cal = eng.calibrator
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = run_calibration(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        rep, stats, skipped = out["report"], out["stats"], cal.skipped()
        print(f"phase 6b: run_calibration in {wall:.1f}s: {stats['kernels']} "
              f"kernels, {stats['applied']} applied, {stats['skipped']} "
              f"skipped {skipped}, {stats['measured_buckets']} buckets, "
              f"{stats['measurements']} candidate timings, "
              f"{stats['seconds']:.2f}s measuring, top_k "
              f"{cal.policy.top_k}, m_max {cal.policy.m_max} on {smi}")
        for kind in CALIB_KINDS:
            r = rep.get(kind)
            if r is None or r["measured_buckets"] < 1:
                fail(f"phase 6b: {kind} measured no bucket ({skipped})")
            if not r["never_worse_on_measured"]:
                fail(f"phase 6b: {kind}'s calibrated pick is slower than the "
                     f"analytical one on a measured bucket")
        if skipped.get("attention") != ATTN_SKIP:
            fail(f"phase 6b: attention was not skipped as exec-specialized: "
                 f"{skipped}")
        # Each measured candidate ran once untimed, then once per round
        # (inner 1): bf16 at tensor_core on the wgmma path, at cuda_core on
        # the FMA loop, and nothing else on the card.
        want: dict[str, int] = {}
        for kind in CALIB_KINDS:
            for b in rep[kind]["buckets"]:
                for backend, n in b["candidates"].items():
                    key = f"{CALIB_FAMILY[kind]}.{backend}"
                    want[key] = want.get(key, 0) + n * (
                        1 + b["rounds"] * cal.policy.inner)
        for fam in ("vortex_gemm", "vortex_grouped_gemm"):
            paths = {p: counts[f"{fam}.{p}"]
                     for p in ("tensor_core", "cuda_core")}
            expected = {p: want.get(f"{fam}.{p}", 0) for p in paths}
            print(f"phase 6b: {fam} measurement launches {counts[fam]} "
                  f"by path {paths}, expected {expected}")
            if counts[fam] != sum(paths.values()) or paths != expected:
                fail(f"phase 6b: {fam} launches {counts[fam]} {paths} do not "
                     f"match the measured candidates' paths")
        for fam in ("flash_attention_prefill", "flash_attention_decode"):
            if counts[fam]:
                fail(f"phase 6b: the skipped attention launched {fam}")

        kerns = {k.workload.kind: k for k in eng.kernels().values()}
        for kind in CALIB_KINDS:
            r, kern = rep[kind], kerns[kind]
            sel, wl = kern.selector, kern.workload
            scale = {b: float("%.4g" % a)
                     for b, a in r["backend_scale"].items()}
            print(f"phase 6b calibration/{kind}: mode={r['mode']} "
                  f"residual={r['residual']:.4g} backend_scale={scale} "
                  f"agreement_rate={r['agreement_rate']:.3f} "
                  f"pinned/measured={r['pinned_buckets']}/"
                  f"{r['measured_buckets']} mean_regret_vs_best="
                  f"{r['mean_regret_vs_best']:.4f} never_worse="
                  f"{r['never_worse_on_measured']} on {smi}")
            for b in r["buckets"]:
                m, dev_us = b["m"], {}
                for which in ("analytical", "calibrated"):
                    idx = b[f"{which}_idx"]
                    if which == "calibrated" and idx == b["analytical_idx"]:
                        dev_us[which] = dev_us["analytical"]
                        continue
                    cand = sel.candidate_selection(idx, m)
                    fn = wl.build_executable(cand, impl="cuda")
                    args = wl.example_args(cand, dtype=dt, device=dev)
                    dev_us[which] = (idx, device_ms(lambda: fn(*args)) * 1e3,
                                     tile(cand))
                a_idx, a_us, a_tile = dev_us["analytical"]
                c_idx, c_us, c_tile = dev_us["calibrated"]
                print(f"phase 6b {kind} m={m}: host analytical_us="
                      f"{b['analytical_us']:.3f} best_us={b['best_us']:.3f} "
                      f"calibrated_us={b['calibrated_us']:.3f} "
                      f"[interleaved_minima, {b['rounds']} rounds]; device "
                      f"analytical_us={a_us:.3f} calibrated_us={c_us:.3f} "
                      f"[torch.profiler]; analytical {a_tile}, calibrated "
                      f"{c_tile}{' (pinned)' if a_idx != c_idx else ''} "
                      f"on {smi}")
            print(f"phase 6b {kind} table entries by backend up to m "
                  f"{sel.table.m_max}: analytical "
                  f"{backend_share(sel.build_calibrated_table())} calibrated "
                  f"{backend_share(sel.table)}")
            pins = [b for b in r["buckets"]
                    if b["calibrated_idx"] != b["analytical_idx"]]
            m = (pins or r["buckets"])[-1]["m"]
            got, ref = calib_after_swap(dev, eng, kind, m, g)
            check(f"phase 6b {kind} after the swap at m={m} "
                  f"({tile(sel.select(m))})", got, ref, TOL[dt])

        eng2 = calib_engine(dev, cache, 8)
        cal2 = eng2.calibrator
        loaded = cal2.load()
        rt = {"loaded": loaded, "re_measurements":
              cal2.counters["measurements"], "pending": cal2.pending()}
        print(f"phase 6b roundtrip: a second engine on the same cache loaded "
              f"{loaded} of {stats['applied']} tables, {rt['re_measurements']} "
              f"re-measurements, pending {rt['pending']}")
        if (loaded != stats["applied"] or rt["re_measurements"]
                or rt["pending"]):
            fail(f"phase 6b roundtrip: {rt}")
    del eng, eng2
    free_cuda()
    return {"report": rep, "stats": stats, "roundtrip": rt, "wall_s": wall}


def phase_served_calibration(dev, kernels, smi: str) -> dict:
    """Phase 6b, second half: granite-moe-1b-a400m at full width and depth
    behind ``ContinuousScheduler`` on an engine calibrating on idle; the
    scheduler's idle ticks calibrate the grouped GEMMs, then new requests
    are served on the swapped tables."""
    import tempfile

    from repro_torch import vortex
    from repro_torch.core.hardware import get_hardware
    from repro_torch.core.workloads import GroupedGemmWorkload
    from repro_torch.kernels.grouped_gemm import (
        vortex_grouped_gemm,
        vortex_grouped_gemm_plain,
    )
    from repro_torch.launch.scheduler import ContinuousScheduler
    from repro_torch.launch.serve import VortexServer
    from repro_torch.models.layers import moe_capacity
    from repro_torch.models.registry import get_config

    cfg = get_config(ARCHS[1])
    dt = torch.bfloat16
    with tempfile.TemporaryDirectory(prefix="vortex-calibration-") as cache:
        eng = vortex.Engine(vortex.EngineConfig(
            backends=(get_hardware("h100_sxm").default_backend,),
            calibration="on-idle", calibration_cache_dir=cache))
        server = VortexServer(cfg, max_cache=512, seed=0, engine=eng)
        server.warmup(max_batch=SCHED_ROWS, m_max=512, max_new=8,
                      capture=False)
        cal = eng.calibrator
        scheds: list = []
        slices: list[dict] = []
        real_slice = cal.run_slice

        def run_slice(budget_s=None):
            sched = scheds[-1]
            busy = any(r is not None for r in sched.rows) or bool(sched._queue)
            t = time.perf_counter()
            n = real_slice(budget_s)
            slices.append({"s": time.perf_counter() - t, "busy": busy,
                           "buckets": n})
            return n

        cal.run_slice = run_slice
        first = sched_requests(np.random.default_rng(0), cfg, 8, (1, 4),
                               (16, 128), (8, 8))
        serve_scheduled(kernels, server, first, batch_rows=SCHED_ROWS,
                        where="phase 6b granite before the swap",
                        compare=False, on_sched=scheds.append)
        grouped = [k for k in eng.kernels().values()
                   if k.workload.kind == "grouped_gemm"]
        served = {
            id(k): sorted({key[0][0] for key, e in k._exec_cache.items()
                           if e.hits})
            for k in grouped
        }
        ticker = ContinuousScheduler(server, batch_rows=SCHED_ROWS)
        scheds.append(ticker)
        ticks = 0
        while cal.pending() and ticks < 200:
            ticker.step()
            ticks += 1
        if cal.pending():
            fail(f"phase 6b: calibration still pending after {ticks} idle "
                 f"ticks: {cal.stats()}")
        donated = sum(sc.stats["calibration_slices"] for sc in scheds)
        budget = cal.policy.budget_s
        print(f"phase 6b granite: {len(slices)} calibration slices "
              f"({donated} donated by idle ticks, {ticks} idle ticks after "
              f"the first drain), budget {budget}s, slice wall s "
              f"{[round(sl['s'], 4) for sl in slices]}, buckets per slice "
              f"{[sl['buckets'] for sl in slices]}; {cal.stats()}")
        if donated < 1 or donated != len(slices):
            fail(f"phase 6b: {donated} donated slices, {len(slices)} ran")
        if any(sl["busy"] for sl in slices):
            fail("phase 6b: a calibration slice ran while a row was active "
                 "or a request was queued")
        skipped = cal.skipped()
        for k in grouped:
            wl = k.workload
            sel = k.selector
            if sel.stats.table_swaps < 1:
                fail(f"phase 6b: grouped GEMM G={wl.G} N={wl.N} K={wl.K} "
                     f"saw no table swap ({skipped})")
            for c in served[id(k)]:
                a = sel.candidate_selection(
                    int(np.argmin(sel.candidate_costs(c))), c)
                print(f"phase 6b granite grouped G={wl.G} N={wl.N} K={wl.K} "
                      f"served C bucket {c}: analytical {tile(a)} -> "
                      f"calibrated {tile(sel.select(c))} (table_swaps "
                      f"{sel.stats.table_swaps})")

        second = sched_requests(np.random.default_rng(1), cfg, 8, (1, 4),
                                (160, 384), (8, 8))
        after = serve_scheduled(kernels, server, second,
                                batch_rows=SCHED_ROWS,
                                where="phase 6b granite after the swap",
                                on_sched=scheds.append)
        for sc in scheds:
            sc.close()
        if server.kv_pool.stats()["leases_active"] != 0:
            fail(f"phase 6b: kv pool leases left: {server.kv_pool.stats()}")

        # Rows 3a/3b (phase 5's grouped GEMM calls) under the analytical
        # and the calibrated tile.
        E, k, fe, d = (cfg.moe.num_experts, cfg.moe.top_k,
                       cfg.moe.d_ff_expert, cfg.d_model)
        G = E * SCHED_ROWS
        kern = eng.kernel_for(GroupedGemmWorkload(C=None, G=G, E=E, N=fe,
                                                  K=d))
        sel = kern.selector
        g = torch.Generator().manual_seed(4)
        w = (torch.randn(E, d, fe, generator=g) * E ** -0.5).to(dev, dt)
        rows = {}
        for row, s in (("3a", 64), ("3b", 1)):
            C = moe_capacity(cfg, s)
            counts = routed_counts(g, SCHED_ROWS, s, E, k, C)
            cnt = torch.tensor(counts, dtype=torch.int32, device=dev)
            picks = {"analytical": sel.candidate_selection(
                int(np.argmin(sel.candidate_costs(C))), C),
                "calibrated": sel.select(C)}
            times = {}
            for which, p in picks.items():
                bm, bn, bk = p.strategy.l1
                x = torch.randn(G, C, d, generator=g).to(dev, dt)
                for i, n in enumerate(counts):
                    x[i, n:] = float("nan")

                def call(x=x, bm=bm, bn=bn, bk=bk, be=p.strategy.backend):
                    return vortex_grouped_gemm(x, w, cnt, block_m=bm,
                                               block_n=bn, block_k=bk,
                                               backend=be)

                check(f"phase 6b row {row} {which} tile {tile(p)}", call(),
                      vortex_grouped_gemm_plain(x, w, cnt), TOL[dt])
                times[which] = device_ms(call)
            rows[row] = times
            print(f"phase 6b row {row} (x=({G},C,{d}) w=({E},{d},{fe}) C={C} "
                  f"rows={sum(counts)}): analytical {tile(picks['analytical'])}"
                  f" {times['analytical']:.4f} ms, calibrated "
                  f"{tile(picks['calibrated'])} {times['calibrated']:.4f} ms "
                  f"[torch.profiler device time] on {smi}")
    del server, eng, kern
    free_cuda()
    return {"slices": slices, "ticks": ticks, "rows": rows,
            "logit_rel": after["logit_rel"]}


# ---------------------------------------------------------------------------
# Phase 7: failure domains -- the degradation ladder, the denylist, chaos
# ---------------------------------------------------------------------------

LADDER_M = 100  # an unaligned gemm extent: one staging and one launch


def host_us(fn, iters: int = 50, before=None) -> float:
    """Median host wall-clock µs of one synchronized call of ``fn``;
    ``before`` runs untimed ahead of each call."""
    ts = []
    for _ in range(iters):
        if before is not None:
            before()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e6)
    return float(np.median(ts))


def ladder_counts(eng) -> dict:
    """quarantined/fallbacks summed over an engine's kinds."""
    st = [s for kind, s in eng.stats().items() if kind != "calibration"]
    return {k: sum(s[k] for s in st) for k in ("quarantined", "fallbacks")}


def gemm_ladder(dev, kernels, smi: str) -> dict:
    """Phase 7: a hammered gemm call exhausts the hand-written candidates
    and raises, leaving nothing quarantined or persisted; a call whose
    best candidate fails walks one rung and persists it; a fresh engine
    on the same cache directory loads it and serves with 0 quarantine
    events; the ladder's µs."""
    import glob

    from repro_torch import vortex
    from repro_torch.core.engine import LadderExhaustedError
    from repro_torch.kernels.gemm import vortex_gemm_plain
    from repro_torch.runtime import faults

    d, dt = 768, torch.bfloat16
    g = torch.Generator().manual_seed(70)
    a = torch.randn(LADDER_M, d, generator=g).to(dev, dt)
    b = torch.randn(d, d, generator=g).to(dev, dt)
    plain = vortex_gemm_plain(a, b)
    cache = tempfile.mkdtemp(prefix="deny-",
                             dir=os.environ["VORTEX_CACHE_DIR"])

    def launches() -> int:
        return kernels.launch_counts()["vortex_gemm"]

    def deny_files() -> list:
        return glob.glob(os.path.join(cache, "*.deny.json"))

    eng = vortex.Engine(calibration_cache_dir=cache)
    rungs = 1 + eng.config.max_kernel_retries
    hammer = faults.FaultPlan({"precompile": range(1, 200),
                               "aot_launch": range(1, 200)})
    n0 = launches()
    try:
        with faults.installed(hammer), vortex.use(eng):
            vortex.ops.gemm(a, b)
        fail("phase 7: the hammered gemm returned on the card; the ladder "
             "has no plain-version rung there")
    except LadderExhaustedError as e:
        raised = e
    torch.cuda.synchronize()
    st = ladder_counts(eng)
    kern = next(iter(eng.kernels().values()))
    print(f"phase 7 hammered gemm ({LADDER_M}x{d} @ {d}x{d} bf16): fired "
          f"{len(hammer.fired)}, raised {type(raised).__name__} from "
          f"{type(raised.__cause__).__name__}, {st}, vortex_gemm launches "
          f"{launches() - n0}, quarantine keys left {len(kern._quarantined)}"
          f", denylist files {len(deny_files())}")
    if len(hammer.fired) != rungs or \
            not isinstance(raised.__cause__, faults.InjectedFault):
        fail(f"phase 7: the hammered gemm did not try {rungs} hand-written "
             f"candidates: fired {hammer.fired}")
    if st != {"quarantined": 0, "fallbacks": 0} or launches() != n0 or \
            kern._quarantined or deny_files():
        fail(f"phase 7: the exhausted ladder left a trace: {st}, "
             f"{kern._quarantined}, {deny_files()}")
    n0 = launches()
    with vortex.use(eng):
        out = vortex.ops.gemm(a, b)
    torch.cuda.synchronize()
    if launches() - n0 != 1 or ladder_counts(eng)["quarantined"]:
        fail("phase 7: the gemm after the exhausted ladder did not launch "
             "its kernel once")
    check("phase 7 gemm after the exhausted ladder", out, plain, TOL[dt])

    eng1 = vortex.Engine(calibration_cache_dir=cache)
    one = faults.FaultPlan({"aot_launch": [1]})
    n0 = launches()
    with faults.installed(one), vortex.use(eng1):
        out1 = vortex.ops.gemm(a, b)
    torch.cuda.synchronize()
    st1 = ladder_counts(eng1)
    kern1 = next(iter(eng1.kernels().values()))
    quarantined = set(kern1._quarantined)
    print(f"phase 7 gemm with its best candidate failing: fired "
          f"{one.fired}, {st1}, vortex_gemm launches {launches() - n0}, "
          f"denylist files {len(deny_files())} holding {len(quarantined)} "
          f"keys")
    if st1 != {"quarantined": 1, "fallbacks": 0} or launches() - n0 != 1:
        fail(f"phase 7: the failed best candidate did not walk one rung: "
             f"{st1}")
    check("phase 7 gemm one rung down", out1, plain, TOL[dt])
    if len(deny_files()) != 1 or len(quarantined) != 1:
        fail(f"phase 7: expected one denylist file of one key, got "
             f"{deny_files()} and {quarantined}")

    eng2 = vortex.Engine(calibration_cache_dir=cache)
    n0 = launches()
    with vortex.use(eng2):
        out2 = vortex.ops.gemm(a, b)
    torch.cuda.synchronize()
    st2 = ladder_counts(eng2)
    kern2 = next(iter(eng2.kernels().values()))
    print(f"phase 7 restart on the same cache: {st2}, vortex_gemm launches "
          f"{launches() - n0}, denylist keys loaded "
          f"{len(kern2._quarantined)}")
    if st2 != {"quarantined": 0, "fallbacks": 0} or launches() - n0 != 1:
        fail(f"phase 7: the restarted engine re-failed a denylisted "
             f"candidate: {st2}")
    if kern2._quarantined != quarantined or \
            kern2._qkey(kern2._select_healthy(LADDER_M)) in quarantined:
        fail("phase 7: the restarted engine did not load the denylist")
    check("phase 7 gemm after restart", out2, plain, TOL[dt])

    # The ladder's cost with warm executables: no persistence, and the
    # quarantine cleared before each timed call so each walks again.
    eng3 = vortex.Engine(denylist_persist=False)

    def call():
        with vortex.use(eng3):
            return vortex.ops.gemm(a, b)

    call()
    kern3 = next(iter(eng3.kernels().values()))
    reset = kern3._quarantined.clear
    healthy = host_us(call, before=reset)
    walk = faults.FaultPlan({"aot_launch": range(1, 1000, 2)})  # odd ones
    with faults.installed(walk):
        reset()
        call()  # builds the next-best candidate's executable
        walked = host_us(call, before=reset)
    exhausted = []

    def call_down():
        try:
            call()
        except LadderExhaustedError:
            exhausted.append(1)

    down = faults.FaultPlan({"aot_launch": range(1, 1000)})
    with faults.installed(down):
        call_down()  # builds the remaining candidates' executables
        raising = host_us(call_down)
    if len(exhausted) != 51 or ladder_counts(eng3)["fallbacks"]:
        fail(f"phase 7: {len(exhausted)} of the 51 down calls exhausted "
             f"the ladder; {ladder_counts(eng3)}")
    print(f"phase 7 gemm ({LADDER_M}x{d} @ {d}x{d} bf16) host us a call: "
          f"healthy {healthy:.1f}, one rung walked {walked:.1f}, "
          f"{rungs} failed rungs then LadderExhaustedError {raising:.1f} "
          f"[median of 50 synchronized calls, host wall-clock] on {smi}")
    return {"healthy_us": healthy, "walked_us": walked,
            "exhausted_us": raising}


def graph_ladder(serve_info) -> dict:
    """Phase 7: a fault aimed at the first launch inside a decode step's
    capture.  The ladder quarantines once, the capture is taken again,
    the graphed logits equal the eager step's on the same engine, and a
    replay fires no fault site."""
    from repro_torch import vortex
    from repro_torch.core.hardware import get_hardware
    from repro_torch.launch.graphs import StepCounters
    from repro_torch.launch.serve import VortexServer
    from repro_torch.runtime import faults

    cfg, params = serve_info["cfg"], serve_info["server"].params
    eng = vortex.Engine(vortex.EngineConfig(
        backends=(get_hardware("h100_sxm").default_backend,),
        denylist_persist=False))
    srv = VortexServer(cfg, max_cache=256, params=params, engine=eng)
    eager = VortexServer(cfg, max_cache=256, params=params, engine=eng,
                         graphs=False)
    rng = np.random.default_rng(71)
    b, s = 2, 40
    tok, cache, _ = srv.prefill(
        rng.integers(0, cfg.vocab, (b, s)).astype(np.int64))

    def clone(c):
        return {k: {n: leaf.clone() for n, leaf in e.items()}
                for k, e in c.items()}

    copy, probe = clone(cache), clone(cache)
    eager.adopt_cache(copy)
    eager.adopt_cache(probe)
    t, pos = tok[:, None], s
    count = faults.FaultPlan({})
    with faults.installed(count):
        eager._decode(probe, t, pos, eager._decode_seen)
    n_step = count.counts.get("aot_launch", 0)
    if not n_step:
        fail("phase 7: a decode step made no engine launch")
    plan = faults.FaultPlan({"aot_launch": [n_step + 1]})
    c0 = srv.stats["decode_graph_captures"]
    try:
        with faults.installed(plan):
            got = srv._decode(cache, t, pos, srv._decode_seen)
            seen = plan.counts["aot_launch"]
            t2 = got.argmax(-1)[:, None]
            got2 = srv._decode(cache, t2, pos + 1, srv._decode_seen)
            replay_seen = plan.counts["aot_launch"] - seen
        want = eager._decode(copy, t, pos, eager._decode_seen)
        want2 = eager._decode(copy, t2, pos + 1, eager._decode_seen)
        graph = srv.graphs.get(srv.graphs.keys()[-1])
        st = ladder_counts(eng)
        captures = srv.stats["decode_graph_captures"] - c0
        print(f"phase 7 decode capture fault ({cfg.name}, b={b}, pos {pos}):"
              f" fired {plan.fired} of {seen} aot_launch checks (4 x "
              f"{n_step} + 1: warm-up, capture with the fault, warm-up, "
              f"capture), {st}, {captures} capture, replay checks "
              f"{replay_seen}; graphed logits vs eager bit-identical="
              f"{torch.equal(got, want) and torch.equal(got2, want2)}")
        if plan.fired != [("aot_launch", n_step + 1)] or \
                seen != 4 * n_step + 1:
            fail(f"phase 7: the capture fault did not lead to one "
                 f"re-capture: fired {plan.fired}, {seen} checks")
        if st != {"quarantined": 1, "fallbacks": 0} or captures != 1:
            fail(f"phase 7: expected one quarantine and one capture, got "
                 f"{st} and {captures}")
        if replay_seen or StepCounters.ladder_moved(graph.delta):
            fail("phase 7: a replay fired a fault site or counts a ladder "
                 "event")
        if not (torch.equal(got, want) and torch.equal(got2, want2)):
            fail("phase 7: graphed logits after the ladder differ from the "
                 "eager step's")
    finally:
        srv.release_cache(cache)
        eager.release_cache(copy)
        eager.release_cache(probe)
    for x in (srv, eager):
        if x.kv_pool.stats()["leases_active"]:
            fail("phase 7: leases left active")
    return {"n_step": n_step}


def phase_failure_domains(dev, kernels, serve_info: dict, smi: str) -> dict:
    """Phase 7: the ladder on a gemm, inside a decode capture, then
    tools/chaos_torch.py for seeds 0-2 in-process."""
    out = gemm_ladder(dev, kernels, smi)
    out.update(graph_ladder(serve_info))
    sys.path.insert(0, str(ROOT / "tools"))
    import chaos_torch

    for seed in (0, 1, 2):
        failures = chaos_torch.run(seed, "cuda")
        free_cuda()
        if failures:
            fail(f"phase 7: tools/chaos_torch.py --seed {seed}: {failures}")
    return out


def tree_leaves(tree: dict, pre: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(tree_leaves(v, pre + (k,)) if isinstance(v, dict)
                   else {pre + (k,): v})
    return out


def train_batch(cfg, step: int, dev) -> dict:
    """The launcher's batch for ``step`` on ``dev`` (no frontend stubs:
    the phase trains text-only models)."""
    from repro_torch.data.pipeline import SyntheticLMDataset

    data = SyntheticLMDataset(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in data.batch_at(step).items()}


def check_grads(cfg, hp, params, where: str) -> dict:
    """One step's gradients (``accumulate_grads`` on batch 0): every leaf
    present, finite and not all zero, float32 when accumulated over
    microbatches (in the parameter's dtype with one, as the
    reference's)."""
    from repro_torch.train.step import accumulate_grads

    loss, _, grads = accumulate_grads(
        cfg, hp, params, train_batch(cfg, 0, params["embed"].device))
    flat, pflat = tree_leaves(grads), tree_leaves(params)
    if flat.keys() != pflat.keys():
        fail(f"phase 8: {where}: gradient leaves {sorted(flat)} != "
             f"parameter leaves {sorted(pflat)}")
    for k, g in flat.items():
        want = (torch.float32 if hp.num_microbatches > 1
                else pflat[k].dtype)
        if g.dtype != want or g.shape != pflat[k].shape:
            fail(f"phase 8: {where}: gradient {k} is {g.dtype} {g.shape}")
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            fail(f"phase 8: {where}: gradient {k} is not finite or all 0")
    return {"loss": float(loss), "leaves": len(flat)}


def train_run(cfg, hp, ckpt: str, dev, fail_at: int | None = None,
              data_vocab: int | None = None):
    """:func:`repro_torch.launch.train.run` at the launcher's batch, seq,
    steps and checkpoint interval, optionally with a SimulatedFailure
    before step ``fail_at`` and the stream's tokens drawn from the first
    ``data_vocab`` ids."""
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.supervisor import SimulatedFailure

    tripped = []

    def hook(step):
        if step == fail_at and not tripped:
            tripped.append(step)
            raise SimulatedFailure(f"injected failure before step {step}")

    return launch_train.run(
        cfg, hp, batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        ckpt_dir=ckpt, ckpt_every=TRAIN_CKPT_EVERY, device=dev,
        data_vocab=data_vocab,
        failure_hook=hook if fail_at is not None else None,
        log=lambda line: print(f"  {line}"))


def restart_check(cfg, hp, dev) -> dict:
    """The launcher's run twice, uninterrupted and with a SimulatedFailure
    before step TRAIN_FAIL_AT, under ``torch.use_deterministic_algorithms``
    (scoped to this check): the embedding's index backward accumulates
    with atomics on the card, whose order varies from run to run, and the
    mode swaps in its sort-based kernel, so the two runs must agree bit
    for bit (tolerance 0).  cuBLAS on one stream is deterministic already
    (``warn_only`` keeps its workspace notice a warning)."""
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            clean = train_run(cfg, hp, d1, dev, data_vocab=LEARN_VOCAB)
            failed = train_run(cfg, hp, d2, dev, fail_at=TRAIN_FAIL_AT,
                               data_vocab=LEARN_VOCAB)
        finally:
            torch.use_deterministic_algorithms(False)
    st = failed.supervisor.stats
    replay = TRAIN_FAIL_AT - TRAIN_FAIL_AT // TRAIN_CKPT_EVERY \
        * TRAIN_CKPT_EVERY
    if (st.failures, st.restores, st.steps_run) != (
            1, 1, TRAIN_STEPS + replay):
        fail(f"phase 8: restart: failures={st.failures} restores="
             f"{st.restores} steps_run={st.steps_run}, expected 1, 1, "
             f"{TRAIN_STEPS + replay}")
    ref = dict(clean.batches)
    by_step: dict = {}
    for step, digest in failed.batches:
        by_step.setdefault(step, []).append(digest)
    replayed = sorted(k for k, v in by_step.items() if len(v) == 2)
    if replayed != list(range(TRAIN_FAIL_AT - replay, TRAIN_FAIL_AT)):
        fail(f"phase 8: restart replayed steps {replayed}")
    if any(set(v) != {ref[k]} for k, v in by_step.items()):
        fail("phase 8: restart: a replayed step saw another batch")
    pa = tree_leaves(clean.state)
    pb = tree_leaves(failed.state)
    diff = max(float((pa[k].detach().float() - pb[k].detach().float())
                     .abs().max()) for k in pa)
    la, lb = clean.losses[TRAIN_STEPS - 1], failed.losses[TRAIN_STEPS - 1]
    if diff != 0.0 or la != lb:
        fail(f"phase 8: restart: the restored run differs from the "
             f"uninterrupted one (max |param diff| {diff}, final loss "
             f"{la} vs {lb})")
    return {"replayed": replayed, "final_loss": la, "max_diff": diff,
            "steps_run": st.steps_run, "run": clean}


def checkpoint_roundtrip(state: dict) -> int:
    """The trained state through ``CheckpointManager.save``/``restore``:
    every bf16 parameter and float32 moment bit-exact, dtypes kept."""
    from repro_torch.checkpoint.manager import CheckpointManager

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(TRAIN_STEPS, state)
        back = mgr.restore(TRAIN_STEPS, state)
    a, b = tree_leaves(state), tree_leaves(back)
    for k, t in a.items():
        u = b[k]
        if u.dtype != t.dtype or u.device != t.device:
            fail(f"phase 8: checkpoint {k}: {u.dtype} on {u.device}")
        bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        view = bits.get(t.dtype)
        same = (torch.equal(t.detach().view(view), u.detach().view(view))
                if view else torch.equal(t, u))
        if not same:
            fail(f"phase 8: checkpoint {k} did not restore bit-exactly")
    return len(a)


def phase_training(dev, kernels, smi: str) -> dict:
    """Phase 8: training on the card, plain torch under autograd (no
    kernel lies on the reference's train path)."""
    import dataclasses

    from torch.utils._pytree import tree_map

    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import get_config
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train.step import make_train_step
    from repro_torch.vortex import session

    before = kernels.launch_counts()
    if session.installed_engine() is not None:
        fail("phase 8: a vortex session is installed")
    cfg = get_config(TRAIN_ARCH)
    hp = train_hparams()
    info: dict = {}

    # The first step's gradients, then one step in bf16 and in float32
    # from the same weights and batch.
    params, opt, step = launch_train.build_trainer(cfg, hp, device=dev)
    info["grads"] = check_grads(cfg, hp, params, TRAIN_ARCH)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.detach().float(), params)
    batch = train_batch(cfg, 0, dev)
    _, _, m16 = step(params, opt, batch)
    _, _, m32 = make_train_step(cfg32, hp)(p32, adamw_init(p32), batch)
    l16, l32 = float(m16["loss"]), float(m32["loss"])
    rel = abs(l16 - l32) / abs(l32)
    if not rel <= BF16_LOSS_TOL:
        fail(f"phase 8: bf16 step loss {l16} vs float32 {l32}: {rel:.2e} "
             f"> {BF16_LOSS_TOL}")
    info["bf16_vs_f32"] = (l16, l32, rel)
    # Device time of one step (torch.profiler, on this throwaway state).
    info["device_ms"] = device_ms(lambda: step(params, opt, batch),
                                  iters=5, warmup=1)
    del params, opt, p32, step
    free_cuda()

    # The launcher's run: 50 steps, a checkpoint every 20, on the
    # launcher's stream over the whole vocabulary (timed).
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        res = train_run(cfg, hp, d, dev)
        wall = time.perf_counter() - t0
        ckpts = sorted(res.supervisor.ckpt.steps())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if ckpts != [20, 40]:
        fail(f"phase 8: checkpoints {ckpts}, expected [20, 40]")
    first, last = loss_trend(res, "the launcher's stream",
                             math.log(cfg.vocab) + DIVERGED)
    secs = [s for _, _, s in res.history[1:]]
    ms = float(np.median(secs)) * 1e3
    info.update(losses=dict(res.losses), first5=first, last5=last, ms=ms,
                ms_mean=float(np.mean(secs)) * 1e3, wall_s=wall,
                tokens_s=TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
                peak_gb=peak_gb, base_gb=base_gb)
    del res
    free_cuda()
    # The same run, uninterrupted and restarted, on the stream restricted
    # to the first LEARN_VOCAB ids, which 50 steps can fit: its loss must
    # fall by LOSS_MARGIN.
    info["restart"] = restart_check(cfg, hp, dev)
    lres = info["restart"].pop("run")
    lfirst, llast = loss_trend(lres, f"the {LEARN_VOCAB}-token stream",
                               math.log(cfg.vocab) + DIVERGED)
    if not lfirst - llast >= LOSS_MARGIN:
        fail(f"phase 8: on the {LEARN_VOCAB}-token stream the mean of the "
             f"last 5 losses ({llast:.4f}) is not {LOSS_MARGIN} below the "
             f"first 5's ({lfirst:.4f})")
    info.update(learn_first5=lfirst, learn_last5=llast,
                ckpt_params=checkpoint_roundtrip(lres.state))
    del lres
    free_cuda()

    # granite-moe at full width, 4 of its 24 layers, 5 steps of one
    # microbatch: the routing and the aux loss under autograd.
    gfull = get_config(GRANITE_TRAIN[0])
    gcfg = dataclasses.replace(gfull, n_layers=GRANITE_TRAIN[1])
    ghp = dataclasses.replace(hp, num_microbatches=1)
    params, opt, step = launch_train.build_trainer(gcfg, ghp, device=dev)
    gi = check_grads(gcfg, ghp, params, gcfg.name)
    stats = []
    for i in range(GRANITE_TRAIN[2]):
        params, opt, m = step(params, opt, train_batch(gcfg, i, dev))
        stats.append(tuple(float(m[k]) for k in
                           ("loss", "aux", "dropped_frac")))
    if not np.isfinite(stats).all() or not all(a > 0 for _, a, _ in stats):
        fail(f"phase 8: {gcfg.name} (loss, aux, dropped_frac): {stats}")
    info["granite"] = {"stats": stats, **gi}
    del params, opt, step
    free_cuda()

    if kernels.launch_counts() != before:
        fail("phase 8: training moved the kernels' launch counters")
    rs = info["restart"]
    print(f"training: {TRAIN_ARCH} (12 layers, d 768, vocab 50257, bf16) "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"{hp.num_microbatches} microbatches, remat, lr {hp.base_lr}: "
          f"{TRAIN_STEPS} steps in {wall:.2f} s; ms_per_step={ms:.2f} "
          f"(median; mean {info['ms_mean']:.2f}) "
          f"tokens_per_s={info['tokens_s']:.1f} "
          f"device_ms_per_step={info['device_ms']:.2f} "
          f"peak_gb={peak_gb:.3f} (base {base_gb:.3f}) on {smi}")
    print(f"training: the launcher's stream (vocab {cfg.vocab}): loss "
          f"first5={first:.4f} last5={last:.4f} margin={first - last:.4f}; "
          f"the {LEARN_VOCAB}-token stream: first5={lfirst:.4f} "
          f"last5={llast:.4f} margin={lfirst - llast:.4f} "
          f"(>= {LOSS_MARGIN})")
    print(f"training: gradients of all {info['grads']['leaves']} leaves "
          f"finite and nonzero; bf16 step loss {l16:.5f} vs float32 "
          f"{l32:.5f} (rel {rel:.2e} <= {BF16_LOSS_TOL})")
    print(f"training: restart at step {TRAIN_FAIL_AT}: restored step "
          f"{rs['replayed'][0]}, replayed {len(rs['replayed'])} steps on "
          f"identical batches, steps_run={rs['steps_run']}, final loss "
          f"{rs['final_loss']:.5f} bit-identical to the uninterrupted run "
          f"(deterministic algorithms); {info['ckpt_params']} leaves of "
          f"the trained state restored bit-exactly")
    print(f"training: {gcfg.name} ({gcfg.n_layers} of {gfull.n_layers} "
          f"layers) "
          f"(loss, aux, dropped_frac) per step: "
          f"{[tuple(round(v, 5) for v in t) for t in stats]}; expert "
          f"stacks' gradients finite and nonzero")
    return info


# ---------------------------------------------------------------------------
# Phase 9: distribution -- the sharded trainer, the seq-sharded decode over
# two ranks, the server on the host mesh
# ---------------------------------------------------------------------------

DIST_STEPS = 5  # 9a: sharded steps held against phase 8's first five
DIST_LOSS_TOL = 1e-3  # relative, per step
# 9b: (arch, layer, batch, q heads, kv heads, head dim, cache rows,
# window, softcap): starcoder2-15b's decode heads and gemma2-9b's local
# layer.  At the production TP of 16 neither 4 nor 8 kv heads divide the
# model axis, so both caches shard on sequence there.
SHARDED_DECODE = (
    ("starcoder2-15b", "", 8, 48, 4, 128, 16384, None, None),
    ("gemma2-9b", " local", 8, 16, 8, 256, 8192, 4096, 50.0),
)
SHARDED_MODEL = ("starcoder2-15b", 2, 8, 16384)  # arch, layers, batch, rows
SHARDED_MODEL_TOL = 5e-2  # as the server's logits: bf16 through 2 layers


def sharded_train(dev, phase8: dict, smi: str) -> dict:
    """9a: gpt2-124m at full width and depth through
    ``build_trainer(mesh=make_host_mesh())`` (a 1x1 DeviceMesh on a
    1-rank NCCL group: parameters DTensors, moments laid out by
    ``opt_state_pspecs``) for DIST_STEPS steps of the launcher's stream,
    against phase 8's losses and a plain run of the same steps."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves as leaves

    from repro_torch.launch import mesh as meshes
    from repro_torch.launch import train as launch_train
    from repro_torch.models.registry import get_config

    cfg = get_config(TRAIN_ARCH)
    hp = train_hparams()
    mesh = meshes.make_host_mesh()
    runs, walls = {}, {}
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for name, m in (("plain", None), ("mesh", mesh)):
                with tempfile.TemporaryDirectory() as d:
                    t0 = time.perf_counter()
                    runs[name] = launch_train.run(
                        cfg, hp, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                        steps=DIST_STEPS, ckpt_dir=d,
                        ckpt_every=TRAIN_CKPT_EVERY, device=dev, mesh=m,
                        log=lambda line: None)
                    walls[name] = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(False)
        sp = runs["mesh"].state["params"]
        if not all(isinstance(t, DTensor) for t in leaves(sp)):
            fail("phase 9a: a parameter of the sharded run is not a DTensor")
        mu = runs["mesh"].state["opt"]["mu"]
        if not all(isinstance(t, DTensor) for t in leaves(mu)):
            fail("phase 9a: a moment of the sharded run is not a DTensor")
        diff = max(float((a.detach().full_tensor().float()
                          - b.detach().float()).abs().max())
                   for a, b in zip(leaves(sp),
                                   leaves(runs["plain"].state["params"])))
        ref = phase8["losses"]
        rows = []
        for i in range(DIST_STEPS):
            got = runs["mesh"].losses[i]
            rel = abs(got - ref[i]) / abs(ref[i])
            rows.append((i, got, ref[i], runs["plain"].losses[i], rel))
            if not rel <= DIST_LOSS_TOL:
                fail(f"phase 9a: step {i} loss {got} vs phase 8's {ref[i]}: "
                     f"{rel:.2e} > {DIST_LOSS_TOL}")
        identical = all(g == p for _, g, _, p, _ in rows)
        secs = [t for _, _, t in runs["mesh"].history[1:]]
        psecs = [t for _, _, t in runs["plain"].history[1:]]
        del runs
        free_cuda()
        # Device time of one sharded step on a fresh trainer.
        params, opt, step = launch_train.build_trainer(cfg, hp, mesh=mesh,
                                                       device=dev)
        batch = train_batch(cfg, 0, dev)
        dms = device_ms(lambda: step(params, opt, batch), iters=3, warmup=1)
        del params, opt, step
    finally:
        meshes.destroy()
    if torch.distributed.is_initialized():
        fail("phase 9a: the process group outlived the phase")
    info = {"ms": float(np.median(secs)) * 1e3,
            "plain_ms": float(np.median(psecs)) * 1e3,
            "device_ms": dms, "identical": identical, "max_diff": diff,
            "losses": rows, "wall_s": walls}
    print(f"distribution 9a: {TRAIN_ARCH} (12 layers, d 768) on a 1x1 "
          f"DeviceMesh (1-rank NCCL), DTensor params, ZeRO-1 moments, "
          f"{DIST_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, "
          f"{hp.num_microbatches} microbatches: ms_per_step={info['ms']:.2f} "
          f"(median of steps 1-{DIST_STEPS - 1}; the plain run "
          f"{info['plain_ms']:.2f}) device_ms_per_step={dms:.2f} "
          f"run_wall_s={walls} on {smi}")
    print(f"distribution 9a: (step, sharded, phase 8, plain) losses "
          f"{[(i, g, p8, p) for i, g, p8, p, _ in rows]}; max rel vs phase "
          f"8 {max(r[-1] for r in rows):.2e} (<= {DIST_LOSS_TOL}); "
          f"bit-identical to the plain run: {identical}; max |param diff| "
          f"after step {DIST_STEPS}: {diff}")
    return info


def production_rules(mesh, cfg):
    """``make_rules`` on ``mesh`` with the production mesh's
    ``kv_heads_act`` (the (16, 16) mesh's): on a model axis of 2 the kv
    heads would divide it and the cache would shard on heads, where in
    production it shards on sequence."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models.partitioning import make_rules

    kw = dict(fsdp=cfg.fsdp, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    rules = make_rules(mesh, **kw)
    prod = make_rules(MeshShape((16, 16), ("data", "model")), **kw)
    return dataclasses.replace(rules, rules={
        **rules.rules, "kv_heads_act": prod.rules["kv_heads_act"]})


def sharded_heads(mesh, dev) -> list[dict]:
    """9b's head-level cases: ``flash_decode_sharded`` on DTensor caches
    against ``_decode_attend`` on the whole cache."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models import model as M
    from repro_torch.models.layers import _decode_attend, flash_decode_sharded
    from repro_torch.models.partitioning import PartitionSpec as P
    from repro_torch.models.partitioning import spec_to_placements
    from repro_torch.models.registry import get_config

    cases = []
    for arch, layer, b, hq, hkv, hd, S, window, cap in SHARDED_DECODE:
        cfg = get_config(arch)
        if (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim) != \
                (hq, hkv, hd):
            fail(f"phase 9b: {arch}'s heads are not {(hq, hkv, hd)}")
        rules = production_rules(mesh, cfg)
        spec = P(*M.cache_pspecs(cfg, rules, b, S)["pos0"]["k"][1:])
        place = spec_to_placements(mesh, spec)
        if not place[1].is_shard(2):
            fail(f"phase 9b: {arch}'s cache is not sequence-sharded: {spec}")
        g = torch.Generator(dev).manual_seed(9)

        def rnd(*shape):
            return torch.randn(shape, generator=g, device=dev).to(
                torch.bfloat16)

        k_full, v_full = rnd(b, hkv, S, hd), rnd(b, hkv, S, hd)
        s_loc = S // mesh.size(1)
        base = mesh.get_local_rank("model") * s_loc
        mine = slice(base, base + s_loc)
        for pos in (0, S // 2, S - 1):
            q = rnd(b, hq, 1, hd)
            kn, vn = rnd(b, hkv, 1, hd), rnd(b, hkv, 1, hd)
            # Clones: the in-place write must not reach the originals.
            kc = distribute_tensor(k_full.clone(), mesh, place,
                                   src_data_rank=None)
            vc = distribute_tensor(v_full.clone(), mesh, place,
                                   src_data_rank=None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out, kc, vc = flash_decode_sharded(
                q, kc, vc, kn, vn, pos, window, cap, hd ** -0.5, rules)
            got = out.full_tensor()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            kr, vr = k_full.clone(), v_full.clone()
            kr[:, :, pos] = kn[:, :, 0]
            vr[:, :, pos] = vn[:, :, 0]
            want = _decode_attend(
                q, kr, vr, torch.full((b,), pos, device=dev), window,
                cap, hd ** -0.5)
            err = float((got.float() - want.float()).abs().max())
            rel = err / max(float(want.float().abs().max()), 1e-30)
            k_loc, v_loc = kc.to_local(), vc.to_local()
            exact = bool(torch.equal(k_loc, kr[:, :, mine])
                         and torch.equal(v_loc, vr[:, :, mine]))
            moved = int((k_loc != k_full[:, :, mine])
                        .any(dim=3).any(dim=1).any(dim=0).sum())
            cases.append(dict(
                name=arch + layer, pos=pos, rel=rel, err=err, exact=exact,
                owned=base <= pos < base + s_loc, rows_moved=moved, ms=ms,
                kv_mb=2 * k_full.numel() * 2 / 1e6, placements=str(place)))
            del kc, vc, kr, vr
    return cases


def sharded_model_decode(mesh, dev) -> dict:
    """9b's model case: one ``decode_step(rules=)`` of SHARDED_MODEL on
    DTensor caches placed by the production ``cache_pspecs``
    (sequence-sharded), through the model's seq-sharded branch, against
    the plain ``decode_step`` on the same weights and cache.

    The weights are replicated DTensors (``param_pspecs`` of rules that
    keep only "batch" and "seq"): DTensor's all-gather over gloo crashes
    on CUDA tensors with this card's torch 2.11, and a vocabulary- or
    head-sharded decode needs one (benchmarks_torch/gloo_cuda_collectives.py
    names the collectives that run).  tests/test_torch_distributed.py
    drives the branch with sharded weights on the CPU."""
    from torch.distributed.tensor import Shard

    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params, param_pspecs
    from repro_torch.models.partitioning import (
        distribute_tree,
        replicated_ops,
    )
    from repro_torch.models.registry import get_config

    arch, layers, b, S = SHARDED_MODEL
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    prod = production_rules(mesh, cfg)
    rules = dataclasses.replace(prod, rules={
        k: v if k in ("batch", "seq") else None
        for k, v in prod.rules.items()})
    if not L._seq_sharded(rules, S):
        fail(f"phase 9b: {arch}'s decode would not take the sharded branch")
    params = init_params(cfg, torch.Generator(dev).manual_seed(3), device=dev)
    g = torch.Generator(dev).manual_seed(4)
    cache = M.make_cache(cfg, b, S, device=dev)
    for leaf in tree_leaves(cache).values():
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=dev))
    toks = torch.randint(0, cfg.vocab, (b, 1), generator=g, device=dev)
    pos = 3 * S // 4 + 5

    def clone(t):
        return ({k: clone(v) for k, v in t.items()} if isinstance(t, dict)
                else t.clone())

    # Each decode writes its own copy; ``cache`` stays as it was.
    sc = distribute_tree(mesh, clone(cache), M.cache_pspecs(cfg, prod, b, S))
    sp = distribute_tree(mesh, params, param_pspecs(cfg, rules))
    plain_cache = clone(cache)
    with torch.no_grad():
        want, _, _ = M.decode_step(cfg, params, plain_cache, toks, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls = []
        inner = L.flash_decode_sharded

        def counted(*args):  # the branch's calls, one a layer
            calls.append(1)
            return inner(*args)

        L.flash_decode_sharded = counted
        try:
            with replicated_ops():
                got, sc, _ = M.decode_step(cfg, sp, sc, toks, pos,
                                           rules=rules)
                got = got.full_tensor()
        finally:
            L.flash_decode_sharded = inner
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    if len(calls) != layers:
        fail(f"phase 9b: {len(calls)} sharded decodes for {layers} layers")
    rel = float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)
    # Each rank checks its own rows (no all-gather: see above).
    s_loc = S // mesh.size(1)
    base = mesh.get_local_rank("model") * s_loc
    mine = slice(base, base + s_loc)
    owned = base <= pos < base + s_loc
    row_rel, others_exact = 0.0, True
    plain, before = tree_leaves(plain_cache), tree_leaves(cache)
    for key, leaf in tree_leaves(sc).items():
        if tuple(leaf.placements)[1] != Shard(3):
            fail(f"phase 9b: cache leaf {key} is laid out {leaf.placements}")
        loc = leaf.to_local()
        keep = torch.ones(s_loc, dtype=torch.bool, device=dev)
        if owned:
            new, ref = loc[:, :, :, pos - base], plain[key][:, :, :, pos]
            row_rel = max(row_rel, float((new.float() - ref.float()).abs()
                                         .max())
                          / max(float(ref.float().abs().max()), 1e-30))
            keep[pos - base] = False
        was = before[key][:, :, :, mine]
        others_exact &= bool(torch.equal(loc[:, :, :, keep],
                                         was[:, :, :, keep]))
    return dict(arch=arch, layers=layers, batch=b, rows=S, pos=pos,
                owned=owned, logit_rel=rel, row_rel=row_rel,
                others_exact=others_exact,
                ms=ms, placements=str(sc["pos0"]["k"].placements))


def sharded_decode_worker(rank: int, world: int, tmp: str) -> None:
    """9b, one rank: a (1, world) DeviceMesh on the card over the gloo
    group (every rank on cuda:0), then the head-level and model cases."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(tmp, "store"), world), world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        out = {"cases": sharded_heads(mesh, dev),
               "model": sharded_model_decode(mesh, dev)}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def sharded_decode(smi: str) -> dict:
    """9b: two spawned ranks on the one card, a gloo group over a
    FileStore, the seq-sharded flash decode at SHARDED_DECODE's shapes
    and SHARDED_MODEL's decode step."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(sharded_decode_worker, args=(2, tmp), nprocs=2)
        wall = time.perf_counter() - t0
        per_rank = [json.loads(pathlib.Path(tmp, f"rank{r}.json")
                               .read_text()) for r in range(2)]
    tol = ATTN_TOL[torch.bfloat16]
    worst = 0.0
    for r, res in enumerate(per_rank):
        m = res["model"]
        if not (m["logit_rel"] <= SHARDED_MODEL_TOL
                and m["row_rel"] <= SHARDED_MODEL_TOL and m["others_exact"]):
            fail(f"phase 9b: rank {r} {m['arch']} decode_step on the mesh "
                 f"vs the plain one: {m}")
        for c in res["cases"]:
            worst = max(worst, c["rel"])
            if not c["rel"] <= tol:
                fail(f"phase 9b: rank {r} {c['name']} pos {c['pos']}: the "
                     f"sharded decode is {c['rel']:.3e} off the unsharded "
                     f"one (> {tol})")
            if not c["exact"] or c["rows_moved"] != int(c["owned"]):
                fail(f"phase 9b: rank {r} {c['name']} pos {c['pos']}: cache "
                     f"writes not exact at the owner only ({c})")
    for c in per_rank[0]["cases"]:
        print(f"distribution 9b: flash_decode_sharded {c['name']} "
              f"({c['kv_mb']:.0f} MB of K/V, placements {c['placements']}) "
              f"pos {c['pos']}: rel {c['rel']:.3e} max_abs_err "
              f"{c['err']:.3e} (<= {tol}), writes exact, owner {c['owned']}, "
              f"{c['ms']:.2f} ms host wall-clock (rank 0)")
    m = per_rank[0]["model"]
    print(f"distribution 9b: decode_step(rules=) {m['arch']} full width, "
          f"{m['layers']} layers, batch {m['batch']}, {m['rows']} rows, pos "
          f"{m['pos']}, caches {m['placements']}, weights replicated: "
          f"logits rel {max(r['model']['logit_rel'] for r in per_rank):.3e}, "
          f"new cache row rel "
          f"{max(r['model']['row_rel'] for r in per_rank):.3e} (<= "
          f"{SHARDED_MODEL_TOL}; the owner's), other rows exact, "
          f"{m['ms']:.1f} ms host wall-clock (rank 0)")
    print(f"distribution 9b: 2 ranks on one card, a (1, 2) DeviceMesh over "
          f"gloo (its collectives on CUDA tensors); worst rel {worst:.3e}; "
          f"wall_s={wall:.1f} on {smi}")
    return {"wall_s": wall, "worst_rel": worst, "model": m}


def mesh_server(kernels, serve_info: dict, smi: str) -> dict:
    """9c: ``VortexServer(cfg, mesh=make_host_mesh())`` on phase 4's
    weights and requests: the same greedy tokens, B2 launched as phase 4
    counts it."""
    from repro_torch.launch import mesh as meshes
    from repro_torch.launch.serve import VortexServer

    cfg = serve_info["cfg"]
    reqs, want = serve_info["reqs"], serve_info["outs"]
    mesh = meshes.make_host_mesh()
    try:
        server = VortexServer(cfg, mesh=mesh, max_cache=256,
                              params=serve_info["server"].params)
        if server.rules is None or server.rules.mesh is not mesh:
            fail("phase 9c: the server built no rules on its mesh")
        server.warmup(max_batch=8, m_max=64, max_new=8)
        before = dict(server.stats)
        kernels.reset_launch_counts()
        outs = [server.generate(r) for r in reqs]
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        meshes.destroy()
    steps = sum(r.max_new - 1 for r in reqs)
    for i, (a, b) in enumerate(zip(outs, want)):
        if not np.array_equal(a, b):
            fail(f"phase 9c: request {i}'s tokens differ from phase 4's")
    replays = (server.stats["decode_graph_replays"]
               - before["decode_graph_replays"])
    if (counts["flash_attention_prefill"] != cfg.n_layers * len(reqs)
            or counts["flash_attention_decode"] != cfg.n_layers * steps
            or replays != steps):
        fail(f"phase 9c: B2 launches {counts}, {replays} replays for "
             f"{steps} steps")
    all_tensor_core(counts, "phase 9c")
    print(f"distribution 9c: VortexServer on the 1x1 host mesh, "
          f"{cfg.name}: {len(reqs)} requests, tokens identical to phase 4's; "
          f"B2 launches prefill={counts['flash_attention_prefill']} "
          f"decode={counts['flash_attention_decode']} "
          f"({cfg.n_layers} a prefill, {cfg.n_layers} a token), "
          f"{replays} decode replays for {steps} steps on {smi}")
    del server
    return {"counts": counts}


def phase_distribution(dev, kernels, serve_info: dict, phase8: dict,
                       smi: str) -> dict:
    """Phase 9: 9a, 9b, 9c, each timed."""
    out = {}
    for name, fn, args in (
            ("9a", sharded_train, (dev, phase8, smi)),
            ("9b", sharded_decode, (smi,)),
            ("9c", mesh_server, (kernels, serve_info, smi))):
        t0 = time.perf_counter()
        out[name] = fn(*args)
        print(f"phase {name}: wall_s={time.perf_counter() - t0:.1f}",
              flush=True)
        free_cuda()
    return out


# ---------------------------------------------------------------------------
# Phase 10: kernels/ops.py, the serve-step builders, the roofline and the
# dry run on the card's machine
# ---------------------------------------------------------------------------

OPS_DTYPES = (torch.bfloat16, torch.float32)
OPS_GEMM = (128, 100, 768, 3072)  # M, m_true, K, N: row 1b's shape
OPS_ATTN = (8, 12, 64, 64, 256)  # b, heads, prompt, head_dim, decode cache
OPS_BACKENDS = ("cuda_core", "tensor_core")
BUILD_ARCH, BUILD_B, BUILD_S, BUILD_STEPS = "paper-gpt2-124m", 8, 64, 8
DRYRUN_CELL = ("gemma2-9b", "decode_32k")
DRYRUN_TABLE_BYTES = 256000 * 3584 * 2  # gemma2-9b's bf16 embedding table
# The other cells of tests/test_torch_dryrun_ref.py (ROADMAP C17-C22;
# jamba's prefill and falcon's train cell left out for time), counted at
# one layer group, in two subprocesses: each train cell leads one.
DRYRUN_MAMBA_CELL = ("falcon-mamba-7b", "prefill_32k")
DRYRUN_MOE_CELL = ("jamba-v0.1-52b", "long_500k")
DRYRUN_GROUP_CELLS = (
    (("h2o-danube-3-4b", "train_4k"), ("deepseek-v2-236b", "decode_32k"),
     ("whisper-small", "prefill_32k")),
    (("phi4-mini-3.8b", "train_4k"), ("gemma2-9b", "prefill_32k"),
     DRYRUN_MAMBA_CELL, DRYRUN_MOE_CELL),
)
# 2x the reference's collective bytes a device in falcon-mamba-7b's
# prefill_32k at one group, 4,362,076,160 (tests/dryrun_ref_oracle.py on
# jax's CPU; no jax on the card's machine), and 1% of one of jamba's
# bf16 expert matrices: the bounds of ROADMAP C21 and C22.
DRYRUN_MAMBA_COLLECTIVES = 2 * 4_362_076_160
DRYRUN_STACK_BYTES = 4096 * 14336 * 2
DRYRUN_TIMEOUT = 300
_DRYRUN_GROUPS = """
import json, sys, time
from repro_torch.launch.dryrun import lower_cell
out = {}
for arch, shape in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    try:
        r = lower_cell(arch, shape, multi_pod=False, groups=1, memory=False)
        r.pop("op_names")
    except Exception as e:  # recorded per cell
        r = {"error": f"{type(e).__name__}: {e}"[:2000]}
    r["wall_s"] = time.perf_counter() - t0
    out[arch + "|" + shape] = r
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
"""


def ops_launch(kernels, fn, want: dict, where: str):
    """``fn()`` once, failing unless ``launch_counts()`` moved by exactly
    ``want`` (every other counter still)."""
    before = kernels.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    moved = fold_feeds({k: after[k] - before.get(k, 0) for k in after
                        if after[k] != before.get(k, 0)}, f"phase 10a: {where}")
    if moved != want:
        fail(f"phase 10a: {where} moved the launch counters by {moved}, "
             f"not {want}")
    return out


def phase_ops(dev, kernels, errs: dict) -> tuple[list[dict], dict]:
    """10a: ``kernels/ops.py`` on the card, bf16 and float32, each wrapper
    under both backends at the shapes of rows 1b, 2a/2b and 4: every call
    one launch of its kernel on the path its dtype and backend name, held
    against its plain version at phase 2's tolerances.  Returns rows for
    the kernels line (timed at the bf16 tensor-core and float32 CUDA-core
    paths; ``launches`` is the wrapper's checked calls in that dtype) and
    the launches per counter over the phase's checked calls."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.attention import (
        attention_path,
        check_attention_backend,
        flash_attention_plain,
    )
    from repro_torch.kernels.conv import conv_weight_matrix, im2col
    from repro_torch.kernels.gemm import (
        check_backend,
        kernel_path,
        vortex_gemm_plain,
    )

    g = torch.Generator().manual_seed(10)
    M, m_true, K, N = OPS_GEMM
    b, H, s, hd, kvb = OPS_ATTN
    cname, hw, cin, cout, stride = RESNET_CONVS[0]
    cb = CONV_BATCHES[-1]
    launches: dict = {}
    rows = []
    for dt in OPS_DTYPES:
        a = torch.randn(M, K, generator=g).to(dev, dt)
        bmat = torch.randn(K, N, generator=g).to(dev, dt)
        q = torch.randn(b, H, s, hd, generator=g).to(dev, dt)
        k, v = (torch.randn(b, H, s, hd, generator=g).to(dev, dt)
                for _ in range(2))
        qd = torch.randn(b, H, 1, hd, generator=g).to(dev, dt)
        kd, vd = (torch.randn(b, H, kvb, hd, generator=g).to(dev, dt)
                  for _ in range(2))
        kv_len = torch.randint(1, kvb + 1, (b,), generator=g).to(dev)
        x = torch.randn(cb, hw, hw, cin, generator=g).to(dev, dt)
        w = (torch.randn(3, 3, cin, cout, generator=g)
             * (9 * cin) ** -0.5).to(dev, dt)
        dl: dict = {}  # this dtype's calls per wrapper
        worst: dict = {}
        for be in OPS_BACKENDS:
            tag = f"{str(dt).removeprefix('torch.')} {be}"
            gpath = kernel_path(check_backend("ops", be, 128, 128, 128), dt)
            apath = attention_path("prefill", check_attention_backend(
                "prefill", be, 128, 128, hd), dt)
            cases = (
                ("matmul", "vortex_gemm", f"vortex_gemm.{gpath}",
                 lambda be=be: ops.matmul(a, bmat, m_true, backend=be),
                 lambda: vortex_gemm_plain(a, bmat, m_true), TOL[dt]),
                ("attention prefill", "flash_attention_prefill",
                 f"flash_attention_{apath}",
                 lambda be=be: ops.attention(q, k, v, backend=be),
                 lambda: flash_attention_plain(q, k, v), ATTN_TOL[dt]),
                ("attention decode", "flash_attention_decode",
                 "flash_attention_decode.split_kv",
                 lambda be=be: ops.attention(qd, kd, vd, kv_len, block_q=1,
                                             causal=False, backend=be),
                 lambda: flash_attention_plain(qd, kd, vd, kv_len,
                                               causal=False), ATTN_TOL[dt]),
                ("conv2d", "vortex_gemm", f"vortex_gemm.{gpath}",
                 lambda be=be: ops.conv2d(x, w, stride=stride, backend=be),
                 lambda: vortex_gemm_plain(*_im2col_operands(
                     x, w, stride, im2col, conv_weight_matrix)).reshape(
                         cb, hw - 2, hw - 2, cout), TOL[dt]),
            )
            for what, total, path, fn, plain, tol in cases:
                out = ops_launch(kernels, fn, {total: 1, path: 1},
                                 f"ops.{what} ({tag})")
                err = check(f"phase 10a ops.{what} {tag}", out, plain(), tol)
                worst[what] = max(worst.get(what, 0.0), err)
                errs[total] = max(errs[total], err)
                dl[what] = dl.get(what, 0) + 1
                for key in (total, path):
                    launches[key] = launches.get(key, 0) + 1
        print(f"phase 10a: ops.matmul/attention/conv2d {dt}: one launch a "
              f"call on the path each backend and dtype name, within "
              f"{TOL[dt]:.3g} / {ATTN_TOL[dt]:.3g} of the plain versions")
        be = "tensor_core" if dt == torch.bfloat16 else "cuda_core"
        nb = a.element_size()
        src_attn = ("src/repro_torch/csrc/attention_tc.cu"
                    if (be, dt) == ("tensor_core", torch.bfloat16)
                    else "src/repro_torch/csrc/attention.cu")
        mask = torch.arange(kvb, device=dev)[None, None, None, :] < \
            kv_len[:, None, None, None]
        x_lib = x.permute(0, 3, 1, 2)
        w_lib = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        cm = cb * (hw - 2) ** 2
        dkv = int(kv_len.sum())
        specs = (
            ("ops.matmul", "src/repro_torch/csrc/gemm.cu",
             "src/repro/kernels/gemm.py:110", "matmul",
             lambda: ops.matmul(a, bmat, m_true, backend=be),
             lambda: vortex_gemm_plain(a, bmat, m_true),
             lambda: torch.matmul(a, bmat),
             nb * (m_true * K + K * N + M * N), 2.0 * m_true * N * K,
             f"row 1b: M={M} m_true={m_true} N={N} K={K} blocks=(128,128,"
             f"128)"),
            ("ops.attention (prefill)", src_attn,
             "src/repro/kernels/attention.py:125", "attention prefill",
             lambda: ops.attention(q, k, v, backend=be),
             lambda: flash_attention_plain(q, k, v),
             lambda: F.scaled_dot_product_attention(q, k, v,
                                                    is_causal=True),
             nb * 4 * b * H * s * hd, 4.0 * hd * b * H * s * (s + 1) / 2,
             f"rows 2a: q=({b},{H},{s},{hd}) causal blocks=(128,128)"),
            ("ops.attention (decode)",
             "src/repro_torch/csrc/attention_decode.cu",
             "src/repro/kernels/attention.py:125", "attention decode",
             lambda: ops.attention(qd, kd, vd, kv_len, block_q=1,
                                   causal=False, backend=be),
             lambda: flash_attention_plain(qd, kd, vd, kv_len, causal=False),
             lambda: F.scaled_dot_product_attention(qd, kd, vd,
                                                    attn_mask=mask),
             nb * (2 * b * H * hd + 2 * H * dkv * hd), 4.0 * hd * H * dkv,
             f"row 2b: q=({b},{H},1,{hd}) cache {kvb} kv_len sum {dkv} "
             f"block_k=128"),
            ("ops.conv2d", "src/repro_torch/kernels/conv.py",
             "src/repro/kernels/conv.py:36", "conv2d",
             lambda: ops.conv2d(x, w, stride=stride, backend=be),
             lambda: vortex_gemm_plain(*_im2col_operands(
                 x, w, stride, im2col, conv_weight_matrix)),
             lambda: F.conv2d(x_lib, w_lib, stride=stride),
             nb * (cb * hw * hw * cin + 9 * cin * cout + cm * cout),
             2.0 * cm * cout * 9 * cin,
             f"row 4: ResNet-50 {cname} x=({cb},{hw},{hw},{cin}) 3x3 "
             f"{cin}->{cout}: im2col + gemm.cu at M={cm} N={cout} "
             f"K={9 * cin}"),
        )
        for name, src, rep, what, fn, plain, lib, nbytes, flops, shape in \
                specs:
            bnd, by = bound_ms(nbytes, flops, dt)
            rows.append(timed(
                {"name": f"{name} {str(dt).removeprefix('torch.')}",
                 "route": "cuda", "source": src, "replaces": rep,
                 "launches": dl[what], "max_abs_err": worst[what],
                 "bound_ms": bnd, "bound_by": by,
                 "shape": f"phase 10a {shape} {be} "
                          f"{str(dt).removeprefix('torch.')}"},
                ms=fn, plain_ms=plain, library_ms=lib))
    torch.cuda.synchronize()
    return rows, launches


def _im2col_operands(x, w, stride, im2col, conv_weight_matrix):
    cols, _ = im2col(x, w.shape[0], w.shape[1], stride)
    return cols, conv_weight_matrix(w)


def build_inputs(cfg, dev):
    g = torch.Generator().manual_seed(100)
    return torch.randint(0, cfg.vocab, (BUILD_B, BUILD_S), generator=g).to(dev)


def phase_builders(dev, kernels, smi: str) -> dict:
    """10b: ``make_prefill_step``/``make_decode_step`` on the 1x1 NCCL mesh
    (DTensor weights and cache) against ``model.prefill_step`` and
    ``decode_step`` with no mesh, paper-gpt2-124m at full width and depth,
    batch 8, prompt 64, 8 greedy decode steps, no session installed (as
    the reference's dry run): tokens identical, logits within LOGIT_TOL."""
    from repro_torch import vortex
    from repro_torch.launch import mesh as meshes
    from repro_torch.models import model as M
    from repro_torch.models.params import init_params, param_pspecs
    from repro_torch.models.partitioning import (
        distribute_tree,
        make_rules,
        replicated_ops,
    )
    from repro_torch.models.registry import get_config
    from repro_torch.train.step import (
        make_decode_step,
        make_prefill_step,
        shard_batch,
    )

    if vortex.installed_engine() is not None:
        fail("phase 10b: a vortex session is installed")
    cfg = get_config(BUILD_ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    tokens = build_inputs(cfg, dev)
    cache_len = BUILD_S + BUILD_STEPS
    kernels.reset_launch_counts()

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache, _ = M.prefill_step(cfg, params, tokens,
                                          cache_len=cache_len,
                                          last=BUILD_S - 1)
        plain_logits, plain_toks = [logits], []
        for i in range(BUILD_STEPS):
            tok = logits[:, :cfg.vocab].argmax(-1)
            plain_toks.append(tok)
            logits, cache, _ = M.decode_step(cfg, params, cache, tok[:, None],
                                             BUILD_S + i)
            plain_logits.append(logits)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    mesh = meshes.make_host_mesh()
    try:
        rules = make_rules(mesh, fsdp=cfg.fsdp, n_heads=cfg.n_heads,
                           n_kv_heads=cfg.n_kv_heads)
        sp = distribute_tree(mesh, params, param_pspecs(cfg, rules))
        prefill = make_prefill_step(cfg, rules, cache_len)
        decode = make_decode_step(cfg, rules, cache_len)
        t0 = time.perf_counter()
        with torch.no_grad(), replicated_ops():
            logits, cache = prefill(sp, shard_batch({"tokens": tokens},
                                                    rules))
            mesh_logits, mesh_toks = [full(logits)], []
            for i in range(BUILD_STEPS):
                tok = full(logits)[:, :cfg.vocab].argmax(-1)
                mesh_toks.append(tok)
                toks = shard_batch({"tokens": tok[:, None]}, rules)["tokens"]
                logits, cache = decode(sp, cache, toks, BUILD_S + i)
                mesh_logits.append(full(logits))
        torch.cuda.synchronize()
        mesh_s = time.perf_counter() - t0
    finally:
        meshes.destroy()
    counts = kernels.launch_counts()
    if any(counts.values()):
        fail(f"phase 10b: kernels launched with no session: {counts}")
    for i, (a, c) in enumerate(zip(plain_toks, mesh_toks)):
        if not torch.equal(a, c):
            fail(f"phase 10b: step {i}'s greedy tokens differ")
    worst = max(rel_err(c[:, :cfg.vocab], a[:, :cfg.vocab])[1]
                for a, c in zip(plain_logits, mesh_logits))
    if not worst <= LOGIT_TOL:
        fail(f"phase 10b: logits rel {worst} > {LOGIT_TOL}")
    bitwise = all(torch.equal(a, c) for a, c in zip(plain_logits,
                                                    mesh_logits))
    print(f"phase 10b: make_prefill_step/make_decode_step on the 1x1 NCCL "
          f"mesh, {cfg.name} full width and depth, batch {BUILD_B}, prompt "
          f"{BUILD_S}, {BUILD_STEPS} decode steps: tokens identical, logits "
          f"rel {worst:.3e} (<= {LOGIT_TOL}), bit-identical={bitwise}; "
          f"no session, 0 kernel launches; host wall {mesh_s:.2f}s on the "
          f"mesh vs {plain_s:.2f}s plain on {smi}")
    return {"cfg": cfg, "params": params, "tokens": tokens,
            "bitwise": bitwise, "worst": worst}


def phase_roofline(dev, info: dict, smi: str) -> dict:
    """10c: the port's op counts of one gpt2-124m prefill and decode step
    (10b's shapes) and one train step (phase 8's), each step's H100_SXM
    roofline terms beside its measured device time; then
    ``tree_device_bytes`` of gpt2's weights and a 256-row cache against
    ``torch.cuda.memory_allocated``'s growth when they are placed."""
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeSpec
    from repro_torch.models.params import (
        count_params,
        init_params,
        param_pspecs,
    )
    from repro_torch.models.partitioning import make_rules
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.roofline import (
        H100_SXM,
        count_costs,
        roofline_report,
        tree_device_bytes,
    )
    from repro_torch.train.step import make_train_step

    cfg, params, tokens = info["cfg"], info["params"], info["tokens"]
    s = BUILD_S
    cache = M.make_cache(cfg, BUILD_B, s + 1, device=dev)
    tok1 = tokens[:, :1]
    hp = train_hparams()
    opt = adamw_init(params)
    tparams = {k: v for k, v in params.items()}
    train = make_train_step(cfg, hp)
    batch = train_batch(cfg, 0, dev)

    def prefill():
        with torch.no_grad():
            return M.prefill_step(cfg, params, tokens, cache_len=s + 1,
                                  last=s - 1)

    def decode():
        with torch.no_grad():
            return M.decode_step(cfg, params, cache, tok1, s)

    def step():
        return train(tparams, opt, batch)

    out = {}
    for name, fn, spec in (
            ("prefill", prefill, ShapeSpec("prefill", s, BUILD_B, "prefill")),
            ("decode", decode, ShapeSpec("decode", s, BUILD_B, "decode")),
            ("train", step, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                      "train"))):
        _, costs = count_costs(fn)
        torch.cuda.synchronize()
        rep = roofline_report(
            arch=cfg.name, shape=spec, mesh_name="1", chips=1, costs=costs,
            cost_analysis=None, cfg=cfg, params=count_params(cfg),
            active_params=cfg.active_param_count(), chip=H100_SXM)
        iters = 5 if name == "train" else 20
        ms = device_ms(fn, iters=iters, warmup=2)
        bound = max(rep.compute_s, rep.memory_s, rep.collective_s) * 1e3
        out[name] = {"flops": costs.flops, "bytes": costs.memory_bytes,
                     "compute_ms": rep.compute_s * 1e3,
                     "memory_ms": rep.memory_s * 1e3,
                     "dominant": rep.dominant, "device_ms": ms,
                     "useful_ratio": rep.useful_ratio}
        print(f"phase 10c: {cfg.name} {name} ({spec.global_batch} x "
              f"{spec.seq_len}): counted {costs.flops:.4g} FLOPs, "
              f"{costs.memory_bytes:.4g} bytes; H100_SXM terms compute "
              f"{rep.compute_s * 1e3:.4f} ms, memory {rep.memory_s * 1e3:.4f}"
              f" ms, collective {rep.collective_s * 1e3:.4f} ms, dominant "
              f"{rep.dominant}, useful {rep.useful_ratio:.3f}; measured "
              f"device {ms:.4f} ms ({bound / ms:.1%} of it at the bound) on "
              f"{smi}")
    del opt, tparams, batch, cache
    free_cuda()

    rules = make_rules(MeshShape((1, 1), ("data", "model")),
                       n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads)
    sizes = {"data": 1, "model": 1}

    def requested() -> int:
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    torch.cuda.synchronize()
    m0, r0 = torch.cuda.memory_allocated(), requested()
    # Drawn on the host and moved leaf by leaf: nothing transient on the
    # card while the placement is measured.
    p2 = init_params(cfg, torch.Generator().manual_seed(1), device=dev)
    c2 = M.make_cache(cfg, 1, 256, device=dev)
    torch.cuda.synchronize()
    grown, req = torch.cuda.memory_allocated() - m0, requested() - r0
    want = (tree_device_bytes(p2, param_pspecs(cfg, rules), sizes)
            + tree_device_bytes(c2, M.cache_pspecs(cfg, rules, 1, 256),
                                sizes))
    leaves = list(tree_leaves(p2).values()) + list(tree_leaves(c2).values())
    # The caching allocator rounds a block under 1 MiB to 512 bytes, and a
    # larger one to its 2 MiB segment granularity or leaves an unsplit
    # remainder under 1 MiB in it: at most 2 MiB a leaf.
    slack = sum(512 if t.numel() * t.element_size() < 2**20 else 2**21
                for t in leaves)
    if req != want or not 0 <= grown - want <= slack:
        fail(f"phase 10c: tree_device_bytes {want:.0f} vs requested "
             f"{req} and memory_allocated growth {grown} (slack {slack} "
             f"over {len(leaves)} leaves)")
    print(f"phase 10c: tree_device_bytes of {cfg.name}'s weights and a "
          f"256-row cache {want:.0f} B = the allocator's requested bytes "
          f"{req}; memory_allocated grew {grown} B (+{grown - want:.0f} B "
          f"over {len(leaves)} leaves, within the allocator's rounding of "
          f"{slack} B) on {smi}")
    out["bytes"] = {"tree": want, "allocated": grown}
    del p2, c2
    return out


def start_dryrun_cell() -> tuple:
    """10d's subprocesses, on the host's CPU with the card hidden, beside
    10a-10c: one dry-run cell (gemma2-9b decode_32k, full width and
    depth) through the CLI, and DRYRUN_GROUP_CELLS at one layer group."""
    tmp = tempfile.TemporaryDirectory(prefix="dryrun-")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    arch, shape = DRYRUN_CELL
    out = os.path.join(tmp.name, "dryrun.json")
    runs = [(["-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape",
              shape, "--mesh", "single", "--out", out], out)]
    for i, cells in enumerate(DRYRUN_GROUP_CELLS):
        out = os.path.join(tmp.name, f"groups{i}.json")
        runs.append((["-c", _DRYRUN_GROUPS, out, json.dumps(cells)], out))
    procs = [(subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True,
                               cwd=str(ROOT), env=env), out)
             for args, out in runs]
    return procs, tmp, time.perf_counter()


def stop_dryrun_cells(started: tuple) -> None:
    for proc, _ in started[0]:
        proc.kill()
        proc.communicate()


def _roof_line(roof: dict) -> str:
    return (f"{roof['flops']:.4g} FLOPs, {roof['memory_bytes']:.4g} bytes, "
            f"{roof['collective_bytes']:.4g} collective bytes a device "
            f"({', '.join(f'{k} {v:.4g}' for k, v in sorted(roof['collective_by_kind'].items()))}), "
            f"dominant {roof['dominant']}")


def finish_dryrun_cell(started: tuple, smi: str) -> dict:
    """10d: every subprocess exits 0 within DRYRUN_TIMEOUT of its start;
    every cell is counted with no error, the full-depth decode cell's
    all-gather does not hold its embedding table (ROADMAP C16), Mamba's
    prefill moves at most 2x the reference's collective bytes (C21) and
    jamba's long decode gathers no expert matrix (C22).  Each cell's time
    is printed."""
    procs, tmp, t0 = started
    errs = []
    for proc, _ in procs:
        try:
            _, err = proc.communicate(timeout=max(
                1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            stop_dryrun_cells(started)
            fail(f"phase 10d: the dry run took over {DRYRUN_TIMEOUT} s")
        errs.append(err)
    wall = time.perf_counter() - t0
    with tmp:
        for (proc, _), err in zip(procs, errs):
            if proc.returncode != 0:
                fail(f"phase 10d: a dry run exited {proc.returncode}: "
                     f"{err[-2000:]}")
        res = []
        for _, out in procs:
            with open(out) as f:
                res.append(json.load(f))
    arch, shape = DRYRUN_CELL
    r = res[0][f"{arch}|{shape}|single"]
    if "error" in r or "roofline" not in r:
        fail(f"phase 10d: {r.get('error', r)}")
    roof = r["roofline"]
    gathered = roof["collective_by_kind"].get("all-gather", 0)
    if gathered >= DRYRUN_TABLE_BYTES:
        fail(f"phase 10d: {arch} {shape} all-gathers {gathered:.4g} bytes a "
             f"device, as much as its {DRYRUN_TABLE_BYTES} B table (C16)")
    print(f"phase 10d: dry run {arch} {shape} on a fake 256-rank world "
          f"(torch {torch.__version__}, CPU): exit 0 in {wall:.1f}s beside "
          f"10a-10c, state {r['state_gib_per_device']:.3f} GiB/dev, counted "
          f"in {r['compile_seconds']:.1f}s ({r['ops_dispatched']} ops): "
          f"{_roof_line(roof)}, all-gather {gathered / DRYRUN_TABLE_BYTES:.2e} "
          f"of the embedding table (V5E terms compute "
          f"{roof['compute_s']:.4g}s memory {roof['memory_s']:.4g}s "
          f"collective {roof['collective_s']:.4g}s); memory_analysis "
          f"{r['memory_analysis']}; {smi}")
    cells = {}
    for got, want in zip(res[1:], DRYRUN_GROUP_CELLS):
        for a, sh in want:
            c = got.get(f"{a}|{sh}", {"error": "not counted"})
            if "error" in c:
                fail(f"phase 10d: {a} {sh} at one group: {c['error']}")
            cells[f"{a}|{sh}"] = c
            print(f"phase 10d: {a} {sh} at one layer group: counted in "
                  f"{c['wall_s']:.1f}s ({c['ops_dispatched']} ops): "
                  f"{_roof_line(c['roofline'])}; torch {torch.__version__}, "
                  f"CPU, beside 10a-10c on {smi}")
    mamba = cells["|".join(DRYRUN_MAMBA_CELL)]["roofline"]
    if mamba["collective_bytes"] > DRYRUN_MAMBA_COLLECTIVES:
        fail(f"phase 10d: {' '.join(DRYRUN_MAMBA_CELL)} moves "
             f"{mamba['collective_bytes']:.4g} collective bytes a device, "
             f"over {DRYRUN_MAMBA_COLLECTIVES:.4g}: 2x the reference's (C21)")
    gathered = cells["|".join(DRYRUN_MOE_CELL)]["roofline"][
        "collective_by_kind"].get("all-gather", 0)
    if gathered >= 0.01 * DRYRUN_STACK_BYTES:
        fail(f"phase 10d: {' '.join(DRYRUN_MOE_CELL)} all-gathers "
             f"{gathered:.4g} bytes a device, 1% or more of an expert's "
             f"{DRYRUN_STACK_BYTES} B matrix (C22)")
    print(f"phase 10d: {' '.join(DRYRUN_MAMBA_CELL)} "
          f"{mamba['collective_bytes']:.4g} collective bytes a device "
          f"<= {DRYRUN_MAMBA_COLLECTIVES:.4g} (C21); "
          f"{' '.join(DRYRUN_MOE_CELL)} all-gather {gathered:.4g} bytes, "
          f"{gathered / DRYRUN_STACK_BYTES:.2e} of an expert's matrix (C22)")
    return {"wall_s": wall, "cell": r, "groups1": cells}


def phase_analysis(dev, kernels, errs: dict, smi: str) -> dict:
    """Phase 10: 10d's subprocess started, 10a-10c, then 10d waited for;
    each timed."""

    def part(name, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        print(f"phase {name}: wall_s={time.perf_counter() - t0:.1f}",
              flush=True)
        return res

    dry = start_dryrun_cell()
    try:
        rows, launches = part("10a", phase_ops, dev, kernels, errs)
        built = part("10b", phase_builders, dev, kernels, smi)
        roof = part("10c", phase_roofline, dev, built, smi)
        del built
        free_cuda()
    except BaseException:  # fail() exits: stop the subprocesses first
        stop_dryrun_cells(dry)
        raise
    dry = part("10d", finish_dryrun_cell, dry, smi)
    return {"rows": rows, "launches": launches, "10c": roof, "10d": dry}


def loss_trend(res, what: str, ceiling: float) -> tuple[float, float]:
    """The means of a run's first and last 5 losses (by step index),
    after checking that every step ran and every loss is finite and
    below ``ceiling``."""
    losses = [res.losses[i] for i in sorted(res.losses)]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() \
            or max(losses) >= ceiling:
        fail(f"phase 8: {what}: {len(losses)} losses, every 5th "
             f"{losses[::5]}, ceiling {ceiling:.3f}")
    print(f"training: {what}: losses every 5th step "
          f"{[round(x, 4) for x in losses[::5]]}")
    return float(np.mean(losses[:5])), float(np.mean(losses[-5:]))


def train_hparams():
    from repro_torch.train.step import TrainHParams

    return TrainHParams(base_lr=TRAIN_LR,
                        warmup_steps=max(TRAIN_STEPS // 10, 1),
                        total_steps=TRAIN_STEPS, num_microbatches=2)


def print_rows(rows: list[dict], smi: str) -> None:
    """The kernel table's rows, one a line, then the card's name (and,
    for ``--gemm-rows``, the rows as one JSON line)."""
    for r in rows:
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        cp = f" cp_async_ms={r['cp_async_ms']:.4f}" if "cp_async_ms" in r \
            else ""
        print(f"{r['name']}: ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
              f"library_ms={lib}{cp} launches={r['launches']} "
              f"[{r['shape']}; torch.profiler device time] on {smi}")
    print(smi)
    if "--gemm-rows" in sys.argv[1:]:
        print(json.dumps({"kernels": rows, "card": smi}))


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda is not available: this script runs on an NVIDIA GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch import kernels
        from repro_torch.kernels.build import library
    except ImportError as e:
        fail(f"the repro_torch package is not beside this script: {e}")
    dev = torch.device("cuda")
    # The compiled library calls of phase 5 keep their caches in the
    # checkout's build directory.
    build = ROOT / "src" / "repro_torch" / "csrc" / "_build"
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(build / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    t0 = time.perf_counter()
    library()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f}s")
    smi = card_name()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    errs = {"vortex_gemm": 0.0, "flash_attention_prefill": 0.0,
            "flash_attention_decode": 0.0, "vortex_grouped_gemm": 0.0}
    if "--gemm-rows" in sys.argv[1:]:
        rows = gemm_rows_only(dev, kernels, errs)
        print_rows(rows, smi)
        return 0

    # No denylist from an earlier run on this machine may steer a
    # selection: the engines' default cache directory is a fresh one.
    cache_root = tempfile.TemporaryDirectory(prefix="vortex-smoke-")
    os.environ["VORTEX_CACHE_DIR"] = cache_root.name
    watch = LadderWatch()

    def phase(label: str, fn, *args, done: str = "", upto=None):
        t = time.perf_counter()
        out = fn(*args)
        done += ("; " if done else "") + watch.check(f"phase {label}", upto)
        print(f"phase {label}: {done + '; ' if done else ''}wall_s="
              f"{time.perf_counter() - t:.1f}", flush=True)
        return out

    def phase2():
        phase_kernels(dev, kernels, errs)
        phase_window_gather(dev, kernels, errs)
        phase_stage(dev, kernels, errs)

    phase("2", phase2, done="kernels agree with their plain versions")
    gemm_info = phase("3", phase_gemm, dev, kernels,
                      done="vortex.ops.gemm main path ok")
    conv_info = phase("3b", phase_conv, dev, kernels,
                      done="vortex.ops.conv2d main path ok")
    phase("3c", phase_fold, dev, kernels,
          done="every kernel path launched on its own operands one row off "
               "its bucket, bit-identical to call_padded")
    serve_info = phase("4", phase_serve, dev, kernels, ARCHS[0],
                       done=f"VortexServer main path on {ARCHS[0]} ok")
    moe_info = phase("4b", phase_serve, dev, kernels, ARCHS[1],
                     done=f"VortexServer main path on {ARCHS[1]} ok")
    phase("4g", lambda: [phase_graphs(i) for i in (serve_info, moe_info)],
          done="graphed decode steps bit-identical to eager ones "
               f"({', '.join(ARCHS)}; {GEMMA2} in phase 4c)")
    phase("4i", lambda: [phase_prefill_graphs(i)
                         for i in (serve_info, moe_info)],
          done=f"graphed prefills bit-identical to eager ones "
               f"({', '.join(ARCHS)})")
    chain_info = phase("4h", phase_chain, dev, kernels, serve_info,
                       done=f"chained prefill on {ARCHS[0]} and {GEMMA2} "
                            f"(2 layers) ok")
    g2_info = phase("4c/4d", phase_gemma2, kernels,
                    done=f"ContinuousScheduler on {GEMMA2} ok")
    dense_info = phase("4e", phase_dense_2l, kernels,
                       done=f"ContinuousScheduler on {', '.join(DENSE_2L)} "
                            f"ok")
    phase("4f", phase_gemma2_f32, kernels,
          done="float32 scheduler tokens equal serial generate() ok")
    mm_info = phase("4j", phase_mla_mamba, dev, kernels, errs, smi,
                    done="MLA and Mamba served at full width: graphed "
                         "tokens equal eager ones, padded and exact "
                         "prefills agree")
    ev_info = phase("4k", phase_encoder_vision, dev, kernels, errs, smi,
                    done="whisper-small and internvl2-26b served at full "
                         "width: graphed tokens equal eager ones, logits "
                         "agree with impl=torch, C13 refused")

    def phase5():
        rows = phase_time(dev, gemm_info, serve_info, errs)
        rows += chain_gemm_rows(dev, chain_info, errs)
        rows.append(stream_gemm_row(dev, errs))
        rows += attention_rows(dev, moe_info, errs, torch.Generator()
                               .manual_seed(6), ", granite 16/8")
        rows += dense_attention_rows(g2_info, dense_info, errs)
        rows += phase_time_moe_conv(dev, moe_info, conv_info, errs)
        rows.append(stage_row(dev, chain_info["stage_launches"], errs))
        return rows + mm_info["rows"] + ev_info["rows"]

    rows = phase("5", phase5, done="kernels timed")
    bench_info = phase("6", phase_bench, kernels, smi,
                       done="the serving snapshot keeps its contracts on "
                            "the card")

    def phase6b():
        phase_calibration(dev, kernels, smi)
        phase_served_calibration(dev, kernels, smi)

    phase("6b", phase6b, done=f"calibration on the card ok ({ARCHS[1]} "
                              f"served after an idle-slice swap)")
    # Phase 7 installs plans on engines of its own; the kernels built
    # before it must stay silent through it.
    n_before_7 = len(watch.stats)
    phase("7", phase_failure_domains, dev, kernels, serve_info, smi,
          done="failure domains on the card ok", upto=n_before_7)
    train_info = phase(
        "8", phase_training, dev, kernels, smi,
        done=f"{TRAIN_ARCH} trained at full width under the supervisor, "
             f"restart bit-identical, launch counters unmoved",
        upto=n_before_7)
    phase("9", phase_distribution, dev, kernels, serve_info, train_info, smi,
          done=f"{TRAIN_ARCH} trained on a 1x1 DTensor mesh within "
               f"{DIST_LOSS_TOL} of phase 8, the seq-sharded decode over 2 "
               f"ranks matches, the host-mesh server's tokens equal phase "
               f"4's", upto=n_before_7)
    analysis = phase(
        "10", phase_analysis, dev, kernels, errs, smi,
        done="kernels/ops.py launches each kernel once a call and agrees, "
             "the serve-step builders' tokens equal the plain steps', the "
             "roofline's bytes match the allocation, the dry-run cell ran",
        upto=n_before_7)
    rows = rows + analysis["rows"]
    cache_root.cleanup()
    print(f"chip_smoke: total wall_s={time.perf_counter() - t0:.1f}")
    print_rows(rows, smi)
    print(json.dumps({"kernels": rows, "card": smi,
                      "phase6_launches": bench_info["launches"],
                      "phase10a_launches": analysis["launches"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
