#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                   # everything, as the check runs it
    python3 chip_smoke.py --rows n15072 --mega-rows n15072   # smallest rows

Phases, each of which fails the run on any error (each prints its seconds):
  1. the card: its name and power limit from ``nvidia-smi``;
  2. build: compiles every CUDA source of the port (``lod.cu``,
     ``megakernel.cu``, ``flash_attention.cu``, ``anneal.cu``) with
     ``nvcc``, one process
     per source, all started together (set-up), and prints each source's
     ``ptxas -v`` lines;
  3. leading-one kernels: each against its plain torch version on the card,
     at the benchmark shapes and the main path's shapes, on edge-case inputs
     (words with the top bit set, empty rows, ``ptr`` at 0, 31, 32 and
     W*32-1, gates all on, all off and mixed); equality must be exact. Then
     kernel and plain version are timed with CUDA events: device time per
     call (100 calls captured in a CUDA graph and replayed, median of 7
     replays) and latency per call from the host (median of 100 calls);
  4. megakernel: the one-launch K-cycle chunk against its plain version
     (the tensor engine's chunk, on the card) for every policy x eject
     configuration on the small matrix graph (2x2) and on n15072 (16x16),
     from four states (cycle 0; mid-run, made by the plain chunk; three
     cycles before completion; the mid-run state with every zero of the
     float planes made -0.0), at K = 1, 7 and 32, on clones of one state:
     every state leaf and the done trace must be equal as bit patterns.
     Also n15072 on 2x2 for every policy (118 RDY words a PE: four summary
     words), the matrix graph on 36x36 and 42x42 (four PEs a thread), on
     48x48 (whose links and RDY rows exceed shared memory: the plan must
     give the ``global`` body) and on 64x64 (4,096 PEs, a loop a thread),
     n470772 on 2x2 for ``ooo`` and ``lru_flat`` where ``--mega-rows`` has
     it (3,678 RDY words a PE: the ``global`` body's three-level pick; from
     three states at K = 1, 7 and 32), and each larger megakernel row's
     policies
     (``--mega-rows`` beyond n15072) from three states (cycle 40, made by
     the plain chunk; half-way to the golden; three cycles before it) at
     K = 1 and 32. Each case runs the body the plan picks and, where that is
     ``shared``, the ``global`` body too. The matrix graph (2x2, 36x36,
     42x42, 48x48) and n15072 (16x16) cases also run traced
     (``TelemetrySpec`` on: the kernel's traced variant against the traced
     plain chunk, every trace leaf bit for bit too; 16 buckets of 8 cycles on
     2x2 and 48x48, the default 64 x 32 on n15072, groups off on the
     four-PEs-a-thread grids 36x36 and 42x42), so every traced instantiation
     runs;
  5. batched megakernel: the batched chunk (one CTA per config; each body,
     as in phase 4) against its plain version (each element through the
     tensor engine's chunk) on a mixed batch (all four policies, ``ooo`` at
     select latency 4, ``scan`` with a budget of 100) on the matrix graph
     and on n15072, every eject
     configuration, from four states (cycle 0; mid-run; each element three
     cycles before its own end; signed zeros) at K = 1, 7 and 32, plus a
     one-cycle tail launch that freezes elements at their budgets; then
     every batch that phases 8, 9 and 12 run (each ``--mega-rows`` row's
     layout groups, both sweeps) and all four policies as one batch on the
     largest row, from each element half-way to its end, three cycles
     before it, and three cycles before the last end (the others done), at
     K = 1 and 32 (1 and 7 above 8 elements), plus a tail launch that
     freezes every other element: every leaf (inactive members' states
     included) and the [K, B] trace equal as bit patterns. The mixed
     batches also run traced (the matrix graph's spec of phase 4 at every
     eject configuration, n15072's at n_first), every trace leaf equal
     too;
 5b. replayed chunks: the ``tensor`` and ``select`` engines' K-cycle chunk
     replayed from its captured CUDA graph (``overlay.ReplayedChunk``)
     against the eager chunk (``make_chunk_fn``, ``make_batch_chunk_fn``)
     on clones of one state, every leaf and the done trace equal as bit
     patterns: both engines, every policy x eject configuration on the
     matrix graph (2x2) and on n15072 (16x16) from phase 4's four states,
     and phase 10's mixed batch (each eject configuration, four states), at
     K = 7 and the engine's own K (one capture per K, the later states
     copied into the captured tensors); traced too at n_first, every
     policy on the matrix graph, the mixed batch and n15072 ``ooo``, so the
     captured graph records the trace updates;
  6. main path, ``engine="select"``: ``repro_torch.run`` on the 16x16 PE
     grid for the Fig. 1 arrow-LU graphs (default rows n15072, n29772,
     n59172 and n117972); every cycle count must equal the reference's
     golden, values must match ``reference_evaluate`` (rtol = atol = 1e-5,
     as the reference's own tests hold them), the n15072 results must equal
     a CPU run of the port bit for bit, the scheduler kernels must have been
     launched during this phase, and each kernel's count must be the chunks'
     replays times the launches their captures recorded (every run ends
     inside a chunk, so no cycle runs eagerly);
  7. main path, ``engine="megakernel"``: the same checks on all seven
     Fig. 1 rows, n15072, n29772, n59172, n117972, n235572, n353172 and
     n470772 (``--mega-rows``), each result bit-identical
     to the select engine's where that phase ran the row too, the megakernel
     launched during this phase, and every chunk on the ``shared`` body (the
     per-body launch counts);
  8. batched main path: the same rows through ``repro_torch.run(gm,
     batch=...)`` with the megakernel, one batch per memory layout (as the
     reference's Fig. 1 benchmark groups them; at n29772 this is the
     reference's ``policy_sweep``): goldens, values, every element
     bit-identical to phase 7's solo run, the batched kernel launched, every
     chunk on the ``shared`` body;
 8b. eject rows: the reference's ``eject`` rows (``ooo`` on a 4x4 grid,
     criticality layout; ``arrow_lu_graph(2, 8, 12, seed=3)`` and
     ``banded_lu_graph(60, 12, seed=3)``) under both eject policies, each
     under ``select`` and ``megakernel``: cycles and deflections at the
     goldens, values, the engines bit-identical;
 8c. chunking rows: n29772 ``ooo`` and ``inorder`` under ``select`` at
     check_every 1 (eager) and auto: the goldens, both bit-identical to
     phase 6's run, simulated cycles/s of each;
 8d. telemetry: n15072 ``ooo`` and ``inorder`` with ``TelemetrySpec()``
     under ``select`` and ``megakernel``, each beside its untraced run
     (equal results; traced and untraced wall): every value of the
     reference's BENCH ``telemetry`` rows, the two engines' traces
     bit-identical and the select traces equal to a CPU run of the port;
     both policies as one traced megakernel batch, each element equal to
     its solo run; the per-cycle trace of n117972 ``ooo``
     (``TelemetrySpec.per_cycle(14213)``, 116 MB) under both engines,
     bit-identical, each trace sum equal to its counter; ``python -m
     repro_torch.telemetry --fig1`` writing two Perfetto traces of
     ``track_count`` tracks; the traced megakernel launched; then the
     traced and untraced chunk's device time at n15072 ``ooo`` in turns,
     the plain traced chunk's, and the traced bytes bound;
  9. full-card sweeps at n29772, one batch each: ``sweep_ooo`` (``ooo`` x
     select latency 1..128, B = 128) and ``sweep_mixed`` (inorder,
     lru_flat, scan x 1..42, B = 126); every element bit-identical to a solo
     megakernel run of its config, the goldens at each policy's default
     latency, every chunk (batched and solo) on the ``shared`` body;
 10. batched select: a small mixed batch under ``engine="select"`` (the
     leading-one kernels element by element) equal to the same batch under
     the megakernel;
 10b. placement: the anneal kernel (``kernels/csrc/anneal.cu``, one launch a
     search) against its plain version on the card, best placements, best
     costs and init costs equal as integers: four graphs and grids (2x2 to
     16x16) x 1, 2, 8 and 40 replicas x one and two rounds (both exchange
     parities) x two seeds, and a batch of three ladders. Then the slice's
     main path, counted (the launch counts set to 0 just before, read just
     after): the BENCH ``placement`` rows n3689 (8x8) and n10308 (16x16),
     each search on the card at its BENCH budget equal to the reference's
     placement (``tests/fixtures/placement_golden.npz``) and costs,
     identity / random / annealed / annealed_identity through
     ``evaluate_placements`` under ``select`` and ``megakernel`` at the BENCH
     cycles, values against ``reference_evaluate``, the engines
     bit-identical; the multilevel row (n117972, 16x16, ratio 32: 5,645
     clusters, costs, 14213 -> 8966 cycles, the fixture's placement) and
     with ``--fig1-full`` ``fig1_full`` (n502447, built in a worker while
     the card works: 19,711 clusters, costs, 56624 -> 47043 cycles) under
     ``megakernel``; the anneal kernel, ``schedule_step`` and the
     batched megakernel must have launched. Then the anneal kernel's device
     time (profiler) beside its plain version's on a short search, and at
     each BENCH row's budget (µs a step and a proposal);
 10c. surrogate: the anneal kernel's ``GUIDED`` instantiation (the
     surrogate-guided search) against its plain version on the card, best
     placements, best costs, init costs and every rung's cost evaluations
     equal as integers: four graphs and grids (2x2, 4x2, 8x8, 16x16) x 1,
     2 and 8 replicas x guide_every 1 and 3, margins 0, +inf and -2.5 and
     one or two rounds cycling through the cases, per graph a coarse guide
     on the quotient graph and a batch of three ladders; at +inf it must
     equal the unguided kernel. Then the slice's main path under the
     megakernel engine, counted: the BENCH ``surrogate`` rows n3689 (8x8)
     and n10308 (16x16) — ``fit_from_sim`` (48 placements) equal to the
     reference's placements and cycles
     (``tests/fixtures/surrogate_golden.npz``), mu and sigma bit-equal,
     beta within 1e-10 relative and gamma_q equal (with the distance of
     gamma * 2^16 from a rounding boundary), the 64 held-out placements'
     cycles, Spearman 0.9611 / 0.9424 and pruned = exhaustive best 807 /
     1652, ``evaluate_placements(prune="surrogate", keep_top=8)``
     simulating exactly the 8 ranked names — and the BENCH ``guided`` rows
     (rounds x 2, margin 0.0): the fixture's placement, costs 1,043,717 /
     2,282,179, cost evaluations 73,481 / 217,408 of 524,288 / 2,097,152
     proposals, 652 / 1372 cycles (unguided 684 / 1448); the guided kernel
     and the batched megakernel must have launched, every chunk on the
     ``shared`` body. Then ``python -m repro_torch.surrogate --smoke`` in a
     process of its own, and the guided kernel's device time (profiler)
     beside its plain version's on a short search, and at each BENCH guided
     budget beside the unguided kernel's (µs a step and a proposal);
 11. megakernel time: device time per K=32 chunk by CUDA events between
     chunks enqueued back to back (median over chunks) at n15072, n117972
     and n470772 for ``ooo`` and ``inorder``, the plain chunk's at n15072
     ``ooo``, the host time per call and the bytes bound; then at n15072
     ``ooo`` the ``global`` body, and at n15072 and n470772 the engine's
     chunk loop
     with one chunk in flight against two (queued), beside the chunks
     launched back to back;
 12. batch scaling: the first B = 1, 8, 32, 64 and 128 configs of ``sweep_ooo``:
     wall, simulated cycles summed over the elements per second, device
     time per K=32 batched chunk, the same B solo runs' summed wall, the
     bytes bound, host time per batched call and kernel launches; at
     B = 8 the plain batched chunk's time; and the device time per K=32
     chunk of two batches with three member policies at n29772,
     ``policy_sweep`` (B = 3) and ``sweep_mixed`` (B = 126);
 13. profiles: ``torch.profiler`` over the first 320 cycles of the n15072
     ``ooo`` select run (set-up, the capture and 20 replays); over its
     chunk loop alone (``run_state`` on a state built beforehand: the
     capture, the replays with the host's read of ``done`` after each, the
     tail); over 20 replays of the captured chunk back to back (n15072
     ``ooo`` select, n29772 ``lru_flat`` select, n15072 ``ooo`` tensor),
     each beside its device and host time per chunk (CUDA events), with
     each leading-one kernel's device us per launch inside the replay
     (PERF.md holds an empty kernel's node time, measured once, beside
     it); over the whole n15072 ``ooo`` megakernel run, over
     its chunk loop alone (``run_state`` on a state built beforehand) and
     over the whole n470772 ``ooo`` megakernel run, each with its device busy
     share, device ops per cycle and top kernels;
 14. flash-attention kernel: against its plain version on the card, in
     float32 (within 1e-4) and bfloat16 (within 2e-2), and per output row
     within that tolerance of |want| plus the row's RMS, max error
     printed, each case on the body ``plan`` must give it (``mma``,
     ``split`` with its ``combine``, ``simt``; the launch counts are
     checked): the reference's five kernel-test shapes (in the Pallas
     kernel's [B, H, T, D] layout), qwen2-0.5b's prefill (batch 8 x 2048
     tokens, 14 over 2 heads, head_dim 64) and decode (one query over a
     2080-key cache, kv_len per row from 1 to 2080), gemma-2b's head_dim 256
     under MQA (prefill and decode), and awkward shapes (Tq 33 and 2047, Tkv
     70 and 2049, head_dim 80, 128 and 256, non-causal, kv_len 1, 64, 65,
     2080); then the mma body's exponential (ex2.approx) against expf on
     the prefill case's scores, within half a bf16 step;
 15. flash-attention time: device time at the prefill and decode shapes in
     bfloat16 (CUDA-graph replay), each body kernel's time by the profiler
     (the simt body's at the prefill shape in float32), beside the plain
     version's, SDPA's (the yardstick, with an explicit mask and without
     one), the host time per call and the bound (FLOPs at 989 TFLOP/s or
     bytes at 3.35 TB/s, whichever is larger);
 16. serve main path: ``repro_torch.launch.serve.main`` for qwen2-0.5b at
     full width in bfloat16, batch 8 x 2048 prompt tokens, 32 new tokens
     (after a warm-up run of 2 new tokens): prefill and decode tok/s, and
     the flash kernel called exactly 24 x 32 times in the counted run: 24
     ``mma`` launches, 744 ``split`` and 744 ``combine``, no ``simt``;
 17. serve consistency: full width in float32 (TF32 off), prefill (on the
     ``simt`` body) and 16 teacher-forced decode steps (``split``) through
     the kernel against ``forward``'s logits, and against the same steps
     with the plain attention on the card, at 3e-4;
 18. against the reference: the numpy recipe's weights in float32, a
     prefill and three decode steps at full width; top-32 logits (indices
     and values) and logsumexp against the golden the JAX package made
     (``tests/fixtures/qwen2_0_5b_golden.npz``), at 1e-4;
 18b. against the reference in bf16: the same recipe in bfloat16 (the
     serve path's dtype; the prefill on the ``mma`` body, the decode steps
     on ``split``) against the reference's bf16 golden
     (``tests/fixtures/qwen2_0_5b_golden_bf16.npz``): per row, the logits
     at the golden's top-32 indices, the top-32 values and the logsumexp
     within 2e-2 x (|golden| + the row's RMS);
 19. serve profiles: ``torch.profiler`` over one prefill of phase 16's
     shape and over 8 decode steps after it, each with its device busy
     share, device ops per step and top kernels.

Each graph is built once (numpy set-up, in worker processes while the
kernels build) and shared by the phases. The card's line is printed again
before the JSON object describing each kernel (the traced megakernel
``mega_chunk_traced`` among them; the second-to-last line); the last line
is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
rest of the repository beside this file, the script exits non-zero before
printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second.
HBM_BYTES_PER_S = 3.35e12

#: Main-path rows: name -> (arrow_lu_graph args, {scheduler: golden cycles}).
#: The goldens are the reference package's cycle counts on the 16x16 grid.
ROWS = {
    "n15072": ((4, 10, 8, 3), {"ooo": 2125, "inorder": 2369}),
    "n29772": ((8, 10, 8, 3), {"ooo": 3974, "inorder": 4393,
                               "lru_flat": 4344, "scan": 4625}),
    "n59172": ((16, 10, 8, 3), {"ooo": 7326, "inorder": 8533}),
    "n117972": ((32, 10, 8, 3), {"ooo": 14213, "inorder": 17004}),
    "n235572": ((64, 10, 8, 3), {"ooo": 27912, "inorder": 33511}),
    "n353172": ((96, 10, 8, 3), {"ooo": 41539, "inorder": 49852}),
    "n470772": ((128, 10, 8, 3), {"ooo": 54943, "inorder": 66669}),
}
#: Default rows of each main path. The select engine replays its chunks
#: from captured CUDA graphs, so its default reaches n117972 (W = 15, the
#: timed kernel shape); the megakernel runs every Fig. 1 row.
SELECT_ROWS = ("n15072", "n29772", "n59172", "n117972")
MEGA_ROWS = ("n15072", "n29772", "n59172", "n117972", "n235572", "n353172",
             "n470772")

#: The reference's ``eject`` rows (its placement benchmark): ``ooo`` on the
#: criticality layout of a 4x4 grid, name -> (generator, arguments with the
#: seed, {eject_policy: (golden cycles, golden deflections)}).
EJECT_ROWS = {
    "arrow_n9838": ("arrow_lu_graph", (2, 8, 12, 3),
                    {"n_first": (3160, 25664), "priority": (3087, 26004)}),
    "banded_n16822": ("banded_lu_graph", (60, 12, 3),
                      {"n_first": (4678, 31203), "priority": (4567, 33693)}),
}
#: The reference's ``chunking`` rows: the row run at check_every 1 and auto
#: under ``select``, the same goldens at both.
CHUNKING_ROW = "n29772"
CHUNKING_POLICIES = ("ooo", "inorder")

#: The reference's ``telemetry`` rows (n15072 with ``TelemetrySpec()``): the
#: BENCH values, {policy: {key: value}}.
TELEMETRY_ROW = "n15072"
TELEMETRY_GOLDENS = {
    "ooo": dict(cycles=2125, ctr_busy_total=13968, ctr_delivered=27936,
                ctr_noc_deflections=96868, ctr_eject_deflections=70,
                ctr_link_busy_max=1449, ctr_stall_no_ready=429437,
                ctr_stall_inject_blocked=86627, ctr_stall_select_wait=0,
                ctr_picks=15071, link_util_p50=0.3819, link_util_p95=0.5464,
                link_util_max=0.6819, pick_pos_mean=28.94,
                ready_depth_mean=0.424),
    "inorder": dict(cycles=2369, ctr_busy_total=13968, ctr_delivered=27936,
                    ctr_noc_deflections=89998, ctr_eject_deflections=63,
                    ctr_link_busy_max=1471, ctr_stall_no_ready=498087,
                    ctr_stall_inject_blocked=80441, ctr_stall_select_wait=0,
                    ctr_picks=15071, link_util_p50=0.3326,
                    link_util_p95=0.4788, link_util_max=0.6209,
                    pick_pos_mean=28.94, ready_depth_mean=0.347),
}
#: The per-cycle trace: one bucket a cycle over the whole ``ooo`` run.
PER_CYCLE_ROW = "n117972"
#: The trace specs of the traced kernel checks (phases 4, 5, 5b), as
#: TelemetrySpec keywords: 16 buckets of 8 cycles (the matrix graph's runs
#: clamp into the last bucket), the default 64 x 32 at n15072 (clamped
#: from cycle 2048), and groups off (null leaves) on the four-PEs-a-thread
#: grids.
TRACE_SPECS = {"small": dict(buckets=16, bucket_cycles=8), "default": {},
               "partial": dict(buckets=8, bucket_cycles=64, links=False,
                               sched=False)}
#: Rows and policies at which a megakernel chunk is timed (K = 32).
MEGA_TIMED_ROWS = ("n15072", "n117972", "n470772")
MEGA_TIMED_POLICIES = ("ooo", "inorder")
MEGA_K = 32

#: Row whose GPU results are also checked bit for bit against a CPU run.
CROSS_CHECK_ROW = "n15072"

#: Benchmark shapes of the reference's kernel bench, plus the main path's
#: RDY shapes on 16x16 (P = 256 rows, W = 2, 4 and 15 words).
KERNEL_SHAPES = [(256, 8), (256, 64), (256, 256), (1024, 64),
                 (256, 2), (256, 4), (256, 15)]
TIMED_SHAPE = (256, 15)   # the deepest main-path shape (n117,972)

KERNELS = {
    "lod": "src/repro/kernels/lod.py:109",
    "schedule_step": "src/repro/kernels/lod.py:130",
    "rotating_schedule_step": "src/repro/kernels/lod.py:167",
}
SOURCE = "src/repro_torch/kernels/csrc/lod.cu"
MEGA_REPLACES = "src/repro/kernels/megakernel.py:68"
MEGA_SOURCE = "src/repro_torch/kernels/csrc/megakernel.cu"
#: Where the reference's kernel gets its traces: the trace leaves are state
#: leaves of its ``pallas_call``.
MEGA_TRACED_REPLACES = "src/repro/kernels/megakernel.py:68 (telemetry on)"

#: The full-card sweeps (one batch each) on this row: (memory layout of the
#: scheduler, policies, select latencies).
SWEEP_ROW = "n29772"
SWEEPS = {"sweep_ooo": ("ooo", ("ooo",), range(1, 129)),
          "sweep_mixed": ("inorder", ("inorder", "lru_flat", "scan"),
                          range(1, 43))}
#: Batch sizes of the scaling phase (the first B configs of sweep_ooo), and
#: the one at which the plain batched chunk is timed for the kernels line.
SCALING_B = (1, 8, 32, 64, 128)
BATCH_TIMED_B = 8
#: The mixed batch of the batched kernel checks: policies on one layout,
#: ``ooo`` at select latency 4, ``scan`` with a short budget.
BATCH_POLICIES = ("inorder", "lru_flat", "ooo", "scan")
#: Batches of at most this many elements are checked at K = 32 as well.
SMALL_B = 8

POLICIES = ("ooo", "inorder", "lru_flat", "scan")
#: Eject configurations: name -> (eject_capacity, eject_policy).
EJECTS = {"n_first_cap1": (1, "n_first"), "priority_cap1": (1, "priority"),
          "cap2": (2, "n_first")}
#: The small matrix graph of the CPU parity tests.
MATRIX_GRAPH = (3, 6, 4, 5)
#: The megakernel body the plan must give a phase 4 grid: n15072 on 2x2 has
#: 118 RDY words a PE (four summary words); 48x48's links and rows exceed
#: a CTA's shared memory; 64x64 has 4,096 PEs; n470772 on 2x2 has 3,678 RDY
#: words a PE (115 summary words).
PLANNED_BODIES = {"n15072 16x16": "shared", "n15072 2x2": "shared",
                  "matrix 36x36": "shared", "matrix 42x42": "shared",
                  "matrix 48x48": "global", "matrix 64x64": "global",
                  "n470772 2x2": "global"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def edge_inputs(torch, np, p, w, seed):
    """RDY words, pointers and three gates exercising the edge cases."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, size=(p, w), dtype=np.uint32)
    bits[rng.random((p, w)) < 0.5] = 0
    bits[rng.random((p, w)) < 0.1] |= np.uint32(0x80000000)   # slot 0 of a word
    bits[rng.random((p, w)) < 0.1] = np.uint32(1)              # last slot of a word
    bits[0] = 0                                                # empty rows
    bits[p // 2] = 0
    bits[1] = 0
    bits[1, -1] = 1                                            # only the last slot
    ptr = rng.integers(0, w * 32, size=p).astype(np.int32)
    ptr[:8] = [0, 31, 32 % (w * 32), w * 32 - 1, 0, 31, 32 % (w * 32), w * 32 - 1]
    gates = {
        "all_on": np.ones(p, bool),
        "all_off": np.zeros(p, bool),
        "mixed": rng.random(p) < 0.5,
    }
    dev = "cuda"
    return (torch.from_numpy(bits.view(np.int32)).to(dev),
            torch.from_numpy(ptr).to(dev),
            {k: torch.from_numpy(v).to(dev) for k, v in gates.items()})


def max_abs_err(torch, got, want):
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(got, want))


def check_kernels(torch, np, lod):
    """Every kernel against its plain version; returns the largest error."""
    err = {k: 0 for k in KERNELS}
    for i, (p, w) in enumerate(KERNEL_SHAPES):
        bits, ptr, gates = edge_inputs(torch, np, p, w, seed=100 + i)
        pairs = [("lod", (lod.lod(bits),), (lod.lod_plain(bits),))]
        for g in (None, *gates.values()):
            pairs.append(("schedule_step", lod.schedule_step(bits, g),
                          lod.schedule_step_plain(bits, g)))
            pairs.append(("rotating_schedule_step",
                          lod.rotating_schedule_step(bits, ptr, g),
                          lod.rotating_schedule_step_plain(bits, ptr, g)))
        torch.cuda.synchronize()
        for name, got, want in pairs:
            e = max_abs_err(torch, got, want)
            err[name] = max(err[name], e)
            if e != 0:
                raise AssertionError(
                    f"{name} differs from its plain version at {p}x{w}: "
                    f"max abs error {e}")
    return err


def call_ms(torch, fn, reps=100, warmup=10):
    """Median of ``reps`` single-call CUDA-event timings, in ms: the latency
    of one call from the host, launch overhead included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, reps=100, rounds=7):
    """Device time of one call, in ms: ``reps`` calls captured in a CUDA
    graph, replayed back to back; the median over ``rounds`` replays of the
    replay time divided by ``reps``. Host launch overhead is left out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def kernel_times(torch, np, lod, p, w):
    """Per kernel at [p, w]: device ms and call ms of the kernel and of its
    plain version, and the bytes the function must move."""
    bits, ptr, gates = edge_inputs(torch, np, p, w, seed=7)
    gate = gates["mixed"]
    words = 4 * p * w
    calls = {
        # bytes: each input read once, each output written once
        "lod": (lambda: lod.lod(bits), lambda: lod.lod_plain(bits),
                words + 4 * p),
        "schedule_step": (lambda: lod.schedule_step(bits, gate),
                          lambda: lod.schedule_step_plain(bits, gate),
                          words + p + 4 * p + words),
        "rotating_schedule_step": (
            lambda: lod.rotating_schedule_step(bits, ptr, gate),
            lambda: lod.rotating_schedule_step_plain(bits, ptr, gate),
            words + 4 * p + p + 4 * p + words),
    }
    return {name: dict(ms=device_ms(torch, k), plain_ms=device_ms(torch, plain),
                       call_ms=call_ms(torch, k),
                       plain_call_ms=call_ms(torch, plain), bytes=nbytes)
            for name, (k, plain, nbytes) in calls.items()}


def row_setup(name):
    """A main-path row's set-up (numpy, on the host): the DataflowGraph, its
    ``reference_evaluate`` values, its 16x16 GraphMemory for each layout its
    policies want, and the seconds it took. Runs in a worker process."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import schedulers
    from repro_torch.core import workloads as wl
    from repro_torch.core.graph import reference_evaluate
    from repro_torch.core.partition import build_graph_memory

    t = time.perf_counter()
    args, goldens = ROWS[name]
    g = wl.arrow_lu_graph(*args[:3], seed=args[3])
    ref = reference_evaluate(g)
    memories = {}
    for sched in goldens:
        crit = schedulers.get(sched).wants_criticality_order
        if crit not in memories:
            memories[crit] = build_graph_memory(g, 16, 16,
                                                criticality_order=crit)
    return g, ref, memories, time.perf_counter() - t


class Graphs:
    """Each main-path graph built once: the DataflowGraph, its
    ``reference_evaluate`` values and its 16x16 GraphMemory per layout.
    ``prefetch`` builds rows in worker processes while the card works (the
    set-up of the larger rows takes tens of seconds of Python)."""

    def __init__(self, pool=None):
        self._graphs, self._memories, self._pending = {}, {}, {}
        self._pool = pool

    def prefetch(self, names):
        for name in names:
            if name not in self._graphs and name not in self._pending:
                self._pending[name] = self._pool.submit(row_setup, name)

    def graph(self, name):
        if name not in self._graphs:
            t = time.perf_counter()
            if name not in self._pending:
                self._pending[name] = None
            job = self._pending.pop(name)
            g, ref, memories, took = (row_setup(name) if job is None
                                      else job.result())
            self._graphs[name] = (g, ref)
            for crit, gm in memories.items():
                self._memories[name, crit] = gm
            print(f"set-up {name}: arrow_lu_graph{ROWS[name][0]} -> "
                  f"{g.num_nodes} nodes, reference values and graph memories "
                  f"in {took:.1f} s ({'here' if job is None else 'a worker'}; "
                  f"waited {time.perf_counter() - t:.1f} s)", flush=True)
        return self._graphs[name]

    def memory(self, name, sched):
        """The GraphMemory ``repro_torch.run`` would build for ``sched``."""
        from repro_torch.core import schedulers
        from repro_torch.core.partition import build_graph_memory

        crit = schedulers.get(sched).wants_criticality_order
        self.graph(name)
        if (name, crit) not in self._memories:
            t = time.perf_counter()
            self._memories[name, crit] = build_graph_memory(
                self.graph(name)[0], 16, 16, criticality_order=crit)
            print(f"set-up {name}: graph memory (criticality order {crit}), "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
        return self._memories[name, crit]


def run_main_path(torch, np, graphs, rows, engine, launch_counts, reset):
    """``repro_torch.run`` with ``engine`` over ``rows``; every run must
    reproduce its golden and match ``reference_evaluate``. The launch counts
    are set to 0 just before the runs and read just after. Returns
    ({(row, sched): SimResult}, counts)."""
    import repro_torch
    from repro_torch.core.overlay import OverlayConfig

    for name in rows:          # set-up before the counted runs
        for sched in ROWS[name][1]:
            graphs.memory(name, sched)
    results = {}
    reset()
    for name in rows:
        _, ref = graphs.graph(name)
        for sched, golden in ROWS[name][1].items():
            gm = graphs.memory(name, sched)
            cfg = OverlayConfig(scheduler=sched, engine=engine)
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = repro_torch.run(gm, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            ok_vals = bool(np.isfinite(r.values).all()) and bool(
                np.allclose(r.values, ref, rtol=1e-5, atol=1e-5))
            print(f"main path {engine} {name} {sched}: cycles {r.cycles} "
                  f"(golden {golden}), done {r.done}, deflections "
                  f"{r.deflections}, wall {wall:.3f} s, "
                  f"{r.cycles / wall:.0f} cycles/s", flush=True)
            if not (r.done and r.cycles == golden and ok_vals):
                raise AssertionError(
                    f"main path {engine} {name} {sched}: cycles {r.cycles} vs "
                    f"golden {golden}, done {r.done}, values match {ok_vals}")
            results[name, sched] = r
    counts = launch_counts()
    print(f"main path {engine} kernel launches: {counts}", flush=True)
    return results, counts


def same_result(np, a, b) -> bool:
    fields = ("cycles", "done", "delivered", "deflections", "busy_cycles",
              "noc_deflections", "eject_deflections")
    return all(getattr(a, f) == getattr(b, f) for f in fields) and (
        np.array_equal(a.values.view(np.int32), b.values.view(np.int32)))


@contextlib.contextmanager
def replays_recorded():
    """Every ``overlay.ReplayedChunk`` the engines make inside the block,
    in a list (its ``replays`` and ``per_replay`` launches are read after)."""
    from repro_torch.core import overlay

    made, cls = [], overlay.ReplayedChunk

    class Recorded(cls):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    overlay.ReplayedChunk = Recorded
    try:
        yield made
    finally:
        overlay.ReplayedChunk = cls


def replayed_launches(made, counts):
    """Launches per kernel that the recorded replays made on the card."""
    return {k: sum(c.replays * c.per_replay.get(k, 0) for c in made)
            for k in counts}


def select_main_path(torch, np, graphs, rows, lod):
    """Phase 6. Every run ends inside a chunk, so no cycle runs eagerly:
    each kernel's launches must be the replays times the launches its
    capture recorded. Returns (results, counts, replays, launches per
    replay of each kernel)."""
    import repro_torch
    from repro_torch.core.overlay import OverlayConfig

    with replays_recorded() as made:
        results, counts = run_main_path(
            torch, np, graphs, rows, "select", lambda: dict(lod.launches),
            lod.reset_launches)
    replays = sum(c.replays for c in made)
    per_replay = {k: sorted({c.per_replay.get(k, 0) for c in made})
                  for k in counts}
    print(f"main path select: {len(made)} captured chunks, {replays} "
          f"replays; launches per replay {per_replay}", flush=True)
    if counts != replayed_launches(made, counts):
        raise AssertionError(f"launches {counts} are not the replays x the "
                             f"captured launches "
                             f"{replayed_launches(made, counts)}")
    for name in rows:
        wanted = {"schedule_step": "ooo" in ROWS[name][1],
                  "rotating_schedule_step": bool(
                      {"scan", "lru_flat"} & set(ROWS[name][1]))}
        for kernel, want in wanted.items():
            if want and counts[kernel] == 0:
                raise AssertionError(f"the main path never launched {kernel}")
    if CROSS_CHECK_ROW in rows:
        # The same runs on the CPU (plain versions in place of the kernels)
        # must give the same bits: counters and values.
        for sched in ROWS[CROSS_CHECK_ROW][1]:
            c = repro_torch.run(graphs.memory(CROSS_CHECK_ROW, sched),
                                OverlayConfig(scheduler=sched), device="cpu")
            same = same_result(np, c, results[CROSS_CHECK_ROW, sched])
            print(f"main path select {CROSS_CHECK_ROW} {sched}: CPU run "
                  f"bit-identical {same}", flush=True)
            if not same:
                raise AssertionError(f"{CROSS_CHECK_ROW} {sched}: GPU and "
                                     f"CPU differ")
    return results, counts, replays, per_replay


def assert_shared_body(counts, label):
    """Every chunk of a main path, solo and batched, took the shared-memory
    body (by the per-body launch counts)."""
    chunks = counts["mega_chunk"] + counts["mega_chunk_batched"]
    if counts["mega_chunk_shared"] != chunks or counts["mega_chunk_global"]:
        raise AssertionError(f"{label}: {chunks} chunks, body launches "
                             f"{counts}")
    print(f"{label}: all {chunks} chunks took the shared body", flush=True)


def mega_main_path(torch, np, graphs, rows, mk, select_results):
    results, counts = run_main_path(
        torch, np, graphs, rows, "megakernel", lambda: dict(mk.launches),
        mk.reset_launches)
    if counts["mega_chunk"] == 0:
        raise AssertionError("the main path never launched mega_chunk")
    assert_shared_body(counts, "main path megakernel")
    for key, r in results.items():
        if key in select_results:
            same = same_result(np, r, select_results[key])
            print(f"main path megakernel {key[0]} {key[1]}: bit-identical to "
                  f"the select engine {same}", flush=True)
            if not same:
                raise AssertionError(f"{key}: megakernel and select differ")
    return results, counts


def layout_groups(policies):
    """Policies grouped by the memory layout they want, as the reference's
    Fig. 1 benchmark groups them into one batch each."""
    from repro_torch.core import schedulers

    groups = {}
    for p in policies:
        groups.setdefault(schedulers.get(p).wants_criticality_order,
                          []).append(p)
    return list(groups.values())


def batched_main_path(torch, np, graphs, rows, mk, solo_results):
    """The megakernel main path through ``run(gm, batch=...)``, one batch
    per memory layout: goldens, values, and every element bit-identical to
    the solo run of phase 7. Counts are set to 0 just before the runs and
    read just after."""
    import repro_torch
    from repro_torch.core.overlay import OverlayConfig

    for name in rows:
        for sched in ROWS[name][1]:
            graphs.memory(name, sched)
    mk.reset_launches()
    for name in rows:
        _, ref = graphs.graph(name)
        for group in layout_groups(ROWS[name][1]):
            cfgs = [OverlayConfig(scheduler=p, engine="megakernel")
                    for p in group]
            torch.cuda.synchronize()
            t = time.perf_counter()
            rs = repro_torch.run(graphs.memory(name, group[0]), batch=cfgs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            for p, r in zip(group, rs):
                golden = ROWS[name][1][p]
                ok_vals = bool(np.isfinite(r.values).all()) and bool(
                    np.allclose(r.values, ref, rtol=1e-5, atol=1e-5))
                same = same_result(np, r, solo_results[name, p])
                print(f"batched main path {name} {p} (batch {group}): cycles "
                      f"{r.cycles} (golden {golden}), done {r.done}, "
                      f"bit-identical to the solo run {same}", flush=True)
                if not (r.done and r.cycles == golden and ok_vals and same):
                    raise AssertionError(
                        f"batched main path {name} {p}: cycles {r.cycles} vs "
                        f"golden {golden}, done {r.done}, values match "
                        f"{ok_vals}, equal to solo {same}")
            print(f"batched main path {name} {group}: wall {wall:.3f} s, "
                  f"{sum(r.cycles for r in rs) / wall:.0f} simulated cycles/s",
                  flush=True)
    counts = dict(mk.launches)
    print(f"batched main path kernel launches: {counts}", flush=True)
    if counts["mega_chunk_batched"] == 0:
        raise AssertionError("the batched main path never launched "
                             "mega_chunk_batched")
    assert_shared_body(counts, "batched main path")
    return counts


def sweep_configs(sweep):
    from repro_torch.core.overlay import OverlayConfig

    _, policies, lats = SWEEPS[sweep]
    return [OverlayConfig(scheduler=p, select_latency=lat, engine="megakernel")
            for p in policies for lat in lats]


def full_card_sweeps(torch, np, graphs, mk):
    """Each sweep as one batch at SWEEP_ROW; every element bit-identical to
    a solo megakernel run of its config, the goldens at each policy's
    default latency, every chunk on the shared body. Returns {sweep: [solo
    wall s per config]}."""
    import repro_torch
    from repro_torch.core import schedulers
    from repro_torch.core.overlay import OverlayConfig

    goldens = ROWS[SWEEP_ROW][1]
    solo_walls = {}
    for sweep, (layout, _, _) in SWEEPS.items():
        graphs.memory(SWEEP_ROW, layout)
    mk.reset_launches()
    for sweep, (layout, _, _) in SWEEPS.items():
        gm = graphs.memory(SWEEP_ROW, layout)
        cfgs = sweep_configs(sweep)
        torch.cuda.synchronize()
        t = time.perf_counter()
        rs = repro_torch.run(gm, batch=cfgs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        walls, at_default = [], 0
        for c, rb in zip(cfgs, rs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = repro_torch.run(gm, c)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if not (rb.done and same_result(np, rb, r)):
                raise AssertionError(
                    f"{sweep} {c.scheduler} latency {c.select_latency}: "
                    f"batch element (cycles {rb.cycles}, done {rb.done}) "
                    f"differs from its solo run (cycles {r.cycles})")
            default = schedulers.get(c.scheduler).sel_lat(
                OverlayConfig(scheduler=c.scheduler), gm.lmax // 32)
            if c.select_latency == default:
                at_default += 1
                if rb.cycles != goldens[c.scheduler]:
                    raise AssertionError(
                        f"{sweep} {c.scheduler} at its default latency "
                        f"{default}: {rb.cycles} cycles, golden "
                        f"{goldens[c.scheduler]}")
        cycles = sum(r.cycles for r in rs)
        print(f"{sweep} {SWEEP_ROW}: B = {len(cfgs)} in one batch, wall "
              f"{wall:.3f} s ({cycles} simulated cycles, {cycles / wall:.0f} "
              f"per s; longest element {max(r.cycles for r in rs)} cycles); "
              f"{len(cfgs)} solo runs {sum(walls):.3f} s; every element "
              f"bit-identical to its solo run; {at_default} elements at "
              f"their default latency equal the goldens", flush=True)
        solo_walls[sweep] = walls
    assert_shared_body(dict(mk.launches), "full-card sweeps")
    return solo_walls


def select_batch(engine, cap=1, pol="n_first"):
    """Phase 10's mixed batch: every policy plus ``ooo`` at select latency
    4, each at a budget of 300 cycles, at one eject configuration."""
    from repro_torch.core.overlay import OverlayConfig

    kw = dict(max_cycles=300, engine=engine, eject_capacity=cap,
              eject_policy=pol)
    return [OverlayConfig(scheduler=p, **kw) for p in BATCH_POLICIES] + [
        OverlayConfig(scheduler="ooo", select_latency=4, **kw)]


def matrix_memory(nx, ny, criticality_order):
    from repro_torch.core import workloads as wl
    from repro_torch.core.partition import build_graph_memory

    b, s, w, seed = MATRIX_GRAPH
    return build_graph_memory(wl.arrow_lu_graph(b, s, w, seed=seed), nx, ny,
                              criticality_order=criticality_order)


def batched_select(torch, np, lod):
    """A small mixed batch under ``engine="select"`` (the leading-one
    kernels element by element) against the same batch under the
    megakernel: the matrix graph, every policy plus ``ooo`` at latency 4,
    each at a budget of 300 cycles."""
    import repro_torch

    gm = matrix_memory(2, 2, True)
    lod.reset_launches()
    sel = repro_torch.run(gm, batch=select_batch("select"))
    counts = dict(lod.launches)
    mega = repro_torch.run(gm, batch=select_batch("megakernel"))
    for c, a, m in zip(select_batch("select"), sel, mega):
        if not same_result(np, a, m):
            raise AssertionError(f"batched select {c.scheduler} latency "
                                 f"{c.select_latency}: differs from the "
                                 f"megakernel batch")
    if counts["schedule_step"] == 0 or counts["rotating_schedule_step"] == 0:
        raise AssertionError(f"the batched select engine launched {counts}")
    print(f"batched select (matrix graph 2x2, B = {len(sel)}, budget 300): "
          f"equal to the megakernel batch; kernel launches {counts}",
          flush=True)


def eject_rows(torch, np):
    """The reference's ``eject`` rows: ``ooo`` on a 4x4 grid under both
    eject policies, each under ``select`` and ``megakernel``: cycles and
    deflections at the goldens, values against ``reference_evaluate``, and
    the two engines' results bit-identical."""
    import repro_torch
    from repro_torch.core import workloads as wl
    from repro_torch.core.graph import reference_evaluate
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.core.partition import build_graph_memory

    for name, (fn, args, goldens) in EJECT_ROWS.items():
        g = getattr(wl, fn)(*args[:-1], seed=args[-1])
        ref = reference_evaluate(g)
        gm = build_graph_memory(g, 4, 4, criticality_order=True)
        for pol, (cycles, defl) in goldens.items():
            got = {}
            for engine in ("select", "megakernel"):
                cfg = OverlayConfig(scheduler="ooo", eject_policy=pol,
                                    max_cycles=4_000_000, engine=engine)
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = repro_torch.run(gm, cfg)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
                ok_vals = bool(np.isfinite(r.values).all()) and bool(
                    np.allclose(r.values, ref, rtol=1e-5, atol=1e-5))
                print(f"eject row {name} {pol} {engine}: cycles {r.cycles} "
                      f"(golden {cycles}), deflections {r.deflections} "
                      f"(golden {defl}), wall {wall:.3f} s", flush=True)
                if not (r.done and (r.cycles, r.deflections) == (cycles, defl)
                        and ok_vals):
                    raise AssertionError(
                        f"eject row {name} {pol} {engine}: cycles "
                        f"{r.cycles}, deflections {r.deflections}, values "
                        f"match {ok_vals}")
                got[engine] = r
            if not same_result(np, got["select"], got["megakernel"]):
                raise AssertionError(f"eject row {name} {pol}: the engines "
                                     f"differ")


def chunking_rows(torch, np, graphs, select_results):
    """The reference's ``chunking`` rows: CHUNKING_ROW under ``select`` at
    check_every 1 (the per-cycle engine, eager) and auto (replayed chunks),
    each policy at its golden, the two bit-identical and equal to phase 6's
    run. Prints simulated cycles/s of each."""
    import repro_torch
    from repro_torch.core.overlay import OverlayConfig

    for sched in CHUNKING_POLICIES:
        gm = graphs.memory(CHUNKING_ROW, sched)
        golden = ROWS[CHUNKING_ROW][1][sched]
        got = []
        for check_every in (1, None):
            cfg = OverlayConfig(scheduler=sched, check_every=check_every)
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = repro_torch.run(gm, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            print(f"chunking row {CHUNKING_ROW} {sched} select check_every "
                  f"{check_every or 'auto'}: cycles {r.cycles} (golden "
                  f"{golden}), wall {wall:.3f} s, {r.cycles / wall:.0f} "
                  f"cycles/s", flush=True)
            if not (r.done and r.cycles == golden):
                raise AssertionError(f"chunking row {sched} check_every "
                                     f"{check_every}: {r.cycles} cycles")
            got.append(r)
        ref = select_results.get((CHUNKING_ROW, sched), got[1])
        if not (same_result(np, got[0], got[1])
                and same_result(np, got[1], ref)):
            raise AssertionError(f"chunking row {sched}: check_every 1 and "
                                 f"auto differ")


def traces_equal(np, a, b) -> bool:
    """Two ``TelemetryResult``s: the same leaves, equal bit for bit."""
    return a.traces.keys() == b.traces.keys() and all(
        a.traces[k].dtype == b.traces[k].dtype == np.int32
        and np.array_equal(a.traces[k], b.traces[k]) for k in a.traces)


def telemetry_values(r) -> dict:
    """The BENCH ``telemetry`` row's values of a traced run."""
    rep = r.telemetry.report()
    return dict(
        cycles=r.cycles, ctr_busy_total=r.busy_cycles,
        ctr_delivered=r.delivered, ctr_noc_deflections=r.noc_deflections,
        ctr_eject_deflections=r.eject_deflections,
        ctr_link_busy_max=rep["links"]["busy_max"],
        ctr_stall_no_ready=rep["stalls"]["no_ready"],
        ctr_stall_inject_blocked=rep["stalls"]["inject_blocked"],
        ctr_stall_select_wait=rep["stalls"]["select_wait"],
        ctr_picks=rep["sched"]["picks"],
        link_util_p50=rep["links"]["util_p50"],
        link_util_p95=rep["links"]["util_p95"],
        link_util_max=rep["links"]["util_max"],
        pick_pos_mean=rep["sched"]["pick_pos_mean"],
        ready_depth_mean=rep["sched"]["ready_depth_mean"])


def timed_run(torch, gm, cfg, **kw):
    """``repro_torch.run(gm, cfg)`` and its wall in s (synchronised)."""
    import repro_torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    r = repro_torch.run(gm, cfg, **kw)
    torch.cuda.synchronize()
    return r, time.perf_counter() - t


def sums_equal_counters(r) -> bool:
    t = r.telemetry.traces
    return (int(t["pe_busy"].sum()) == r.busy_cycles
            and int(t["eject_grant"].sum()) == r.delivered
            and int(t["defl_noc"].sum()) == r.noc_deflections
            and int(t["defl_eject"].sum()) == r.eject_deflections)


def telemetry_phase(torch, np, graphs, mk):
    """Phase 7c, the traced main path. TELEMETRY_ROW ``ooo`` and
    ``inorder`` with ``TelemetrySpec()`` under ``select`` and
    ``megakernel``, each beside its untraced run: the same results, every
    BENCH ``telemetry`` value, the two engines' traces bit-identical and the
    select traces equal to a CPU run of the port; both policies as one
    traced megakernel batch, each element equal to its solo run; the
    per-cycle trace of PER_CYCLE_ROW ``ooo`` under both engines,
    bit-identical, each leaf's sum equal to its counter; the CLI's Fig. 1
    traces. The launch counts are set to 0 before the runs and read after
    them. Then the traced and untraced chunk's device time at
    TELEMETRY_ROW ``ooo``, in turns. Returns the numbers."""
    import os
    import tempfile

    import repro_torch
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.telemetry import TelemetrySpec
    from repro_torch.telemetry.perfetto import track_count

    spec = TelemetrySpec()
    for sched in TELEMETRY_GOLDENS:
        graphs.memory(TELEMETRY_ROW, sched)
    graphs.memory(PER_CYCLE_ROW, "ooo")
    mk.reset_launches()
    walls = {}
    for sched, want in TELEMETRY_GOLDENS.items():
        gm = graphs.memory(TELEMETRY_ROW, sched)
        tels = {}
        for engine in ("select", "megakernel"):
            cfg = OverlayConfig(scheduler=sched, engine=engine)
            off, w_off = timed_run(torch, gm, cfg)
            r, w_on = timed_run(torch, gm, dataclasses.replace(
                cfg, telemetry=spec))
            walls[sched, engine] = (w_off, w_on)
            got = telemetry_values(r)
            print(f"telemetry {TELEMETRY_ROW} {sched} {engine}: cycles "
                  f"{r.cycles}, wall {w_on:.3f} s traced / {w_off:.3f} s "
                  f"untraced ({w_on / w_off:.3f}x); {got}", flush=True)
            if not (same_result(np, r, off) and got == want):
                raise AssertionError(
                    f"telemetry {sched} {engine}: equal to the untraced run "
                    f"{same_result(np, r, off)}; values {got} against the "
                    f"goldens {want}")
            tels[engine] = r.telemetry
        cpu = repro_torch.run(gm, OverlayConfig(scheduler=sched,
                                                telemetry=spec), device="cpu")
        same = (traces_equal(np, tels["select"], tels["megakernel"]),
                traces_equal(np, tels["select"], cpu.telemetry))
        print(f"telemetry {TELEMETRY_ROW} {sched}: select and megakernel "
              f"traces bit-identical {same[0]}, select and a CPU run "
              f"{same[1]}", flush=True)
        if not all(same):
            raise AssertionError(f"telemetry {sched}: traces differ {same}")
    # Both policies as one traced batch on one layout, against solo runs of
    # the same configs on that layout.
    gm = graphs.memory(TELEMETRY_ROW, "ooo")
    cfgs = [OverlayConfig(scheduler=p, engine="megakernel", telemetry=spec)
            for p in TELEMETRY_GOLDENS]
    torch.cuda.synchronize()
    t = time.perf_counter()
    batch = repro_torch.run(gm, batch=cfgs)
    torch.cuda.synchronize()
    b_wall = time.perf_counter() - t
    for c, rb in zip(cfgs, batch):
        solo = repro_torch.run(gm, c)
        if not (same_result(np, rb, solo)
                and traces_equal(np, rb.telemetry, solo.telemetry)):
            raise AssertionError(f"traced batch {c.scheduler}: differs from "
                                 f"its solo run")
    print(f"telemetry batch {TELEMETRY_ROW} {[c.scheduler for c in cfgs]} "
          f"(criticality layout): every element equal to its solo run, "
          f"traces included; wall {b_wall:.3f} s", flush=True)
    # One bucket a cycle over a whole run.
    golden = ROWS[PER_CYCLE_ROW][1]["ooo"]
    per_cycle = TelemetrySpec.per_cycle(golden)
    gm = graphs.memory(PER_CYCLE_ROW, "ooo")
    tels = {}
    for engine in ("megakernel", "select"):
        r, wall = timed_run(torch, gm, OverlayConfig(
            scheduler="ooo", engine=engine, telemetry=per_cycle))
        tel_bytes = per_cycle.memory_bytes(16, 16)
        print(f"telemetry per cycle {PER_CYCLE_ROW} ooo {engine}: cycles "
              f"{r.cycles} (golden {golden}), {tel_bytes} bytes of trace, "
              f"wall {wall:.3f} s, sums equal the counters "
              f"{sums_equal_counters(r)}", flush=True)
        if not (r.done and r.cycles == golden and sums_equal_counters(r)):
            raise AssertionError(f"per-cycle trace {engine}: cycles "
                                 f"{r.cycles}, sums equal the counters "
                                 f"{sums_equal_counters(r)}")
        tels[engine] = r.telemetry
    if not traces_equal(np, tels["megakernel"], tels["select"]):
        raise AssertionError("per-cycle traces differ between the engines")
    print(f"telemetry per cycle {PER_CYCLE_ROW}: megakernel and select "
          f"traces bit-identical", flush=True)
    counts = dict(mk.launches)
    print(f"telemetry kernel launches: {counts}", flush=True)
    if counts["mega_chunk_traced"] == 0:
        raise AssertionError("the telemetry phase never launched the traced "
                             "megakernel")
    assert_shared_body(counts, "telemetry")
    # The CLI, on the card: the Fig. 1 graph's traces as Perfetto JSON.
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   REPRO_GRAPH_CACHE=os.path.join(out, "cache"))
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.telemetry", "--fig1", "--out",
             out], env=env, cwd=ROOT, capture_output=True, text=True,
            timeout=300)
        if proc.returncode != 0:
            raise AssertionError(
                f"telemetry CLI failed:\n{proc.stderr[-3000:]}")
        want = track_count(spec, 16, 16)
        files = sorted(f for f in os.listdir(out) if f.endswith(".json"))
        for f in files:
            with open(os.path.join(out, f)) as fh:
                events = json.load(fh)["traceEvents"]
            tracks = {(e["pid"], e["name"]) for e in events if e["ph"] == "C"}
            if len(tracks) != want:
                raise AssertionError(f"{f}: {len(tracks)} tracks, not {want}")
        print(f"telemetry CLI --fig1: {files}, {want} counter tracks each, "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        if len(files) != 2:
            raise AssertionError(f"telemetry CLI wrote {files}")
    # The chunk's device time, traced and untraced in turns.
    timed = {}
    for tel in (None, spec, spec, None):
        mt = mega_times(torch, graphs, mk, TELEMETRY_ROW, "ooo",
                        5 if tel is not None and "traced" not in timed else 0,
                        telemetry=tel)
        key = "untraced" if tel is None else "traced"
        timed.setdefault(key, []).append(mt)
    t_ms = [m["ms"] for m in timed["traced"]]
    u_ms = [m["ms"] for m in timed["untraced"]]
    tr = timed["traced"][0]
    print(f"telemetry chunk time {TELEMETRY_ROW} ooo K={MEGA_K}: traced "
          f"{t_ms[0] * 1e3:.1f} / {t_ms[1] * 1e3:.1f} us, untraced "
          f"{u_ms[0] * 1e3:.1f} / {u_ms[1] * 1e3:.1f} us (in turns: untraced, "
          f"traced, traced, untraced); plain traced chunk "
          f"{tr['plain_ms'] * 1e3:.1f} us; traced bytes bound "
          f"{tr['bytes'] / HBM_BYTES_PER_S * 1e6:.3f} us ({tr['bytes']} "
          f"bytes), host {tr['call_ms'] * 1e3:.1f} us per call", flush=True)
    return dict(launches=counts["mega_chunk_traced"], ms=min(t_ms),
                traced_ms=t_ms, untraced_ms=u_ms, plain_ms=tr["plain_ms"],
                bytes=tr["bytes"], call_ms=tr["call_ms"], shape=tr["shape"],
                walls={f"{k[0]} {k[1]}": v for k, v in walls.items()})


def clone_state(s):
    return {k: clone_state(v) if isinstance(v, dict) else v.clone()
            for k, v in s.items()}


def state_err(torch, got, want, path=""):
    """Largest |difference| over the leaves (floats as floats); raises
    unless every leaf is equal as a bit pattern."""
    err = 0.0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            err = max(err, state_err(torch, g, w, f"{path}/{k}"))
            continue
        if w.dtype == torch.float32:
            d = (g.double() - w.double()).abs()
            bits_equal = torch.equal(g.view(torch.int32), w.view(torch.int32))
        else:
            d = (g.to(torch.float64) - w.to(torch.float64)).abs()
            bits_equal = torch.equal(g, w)
        e = float(d.nan_to_num(nan=float("inf")).max()) if d.numel() else 0.0
        if not bits_equal:
            raise AssertionError(f"state leaf {path}/{k} differs from the "
                                 f"plain chunk (max abs error {e})")
        err = max(err, e)
    return err


def bodies(mk, g, members):
    """The kernel bodies a check runs on ``g``: the one the plan picks, and
    the ``global`` body where the plan picks ``shared`` (it runs any grid
    the plan takes, so both are held to the plain chunk)."""
    nx, ny, L = g["opcode"].shape
    picked = mk.plan(nx, ny, L, members).body
    return [picked] + (["global"] if picked == "shared" else [])


def compare_chunks(torch, mk, g, cfg, states, ks, label):
    """For each start state and K: the plain chunk and the kernel chunk of
    each body (``bodies``) on clones of the state; every leaf and the done
    trace must be equal as bit patterns. Returns the largest abs error and
    the number of cases."""
    err, cases = 0.0, 0
    for sname, st in states.items():
        for K in ks:
            want, want_tr = mk.mega_chunk_plain(
                g, cfg, K, with_trace=True)(clone_state(st))
            for body in bodies(mk, g, (cfg.scheduler,)):
                got, got_tr = mk.make_mega_chunk_fn(
                    g, cfg, K, with_trace=True, body=body)(clone_state(st))
                torch.cuda.synchronize()
                err = max(err, state_err(torch, got, want))
                if not torch.equal(got_tr, want_tr):
                    raise AssertionError(f"megakernel done trace differs: "
                                         f"{label} {sname} K={K} {body}")
                cases += 1
    return err, cases


def signed_zeros(torch, state):
    """A clone of ``state`` with every zero of its float planes made -0.0."""
    out = clone_state(state)
    for leaf in ("operands", "value"):
        out[leaf] = torch.where(out[leaf] == 0,
                                torch.full_like(out[leaf], -0.0), out[leaf])
    return out


def start_states(torch, mk, g, cfg):
    """Phase 4's four start states of a solo run of ``cfg`` (a megakernel
    config): cycle 0; mid-run (40 cycles of the plain chunk); three cycles
    before completion (by the engine); the mid-run state with signed
    zeros. Returns (states, the cycle the run ends at)."""
    from repro_torch.core.overlay import init_state, run_state

    s0 = init_state(g, cfg)
    end = int(run_state(g, cfg, clone_state(s0))["cycle"])
    late = run_state(g, dataclasses.replace(cfg, max_cycles=max(end - 3, 0)),
                     clone_state(s0))
    mid = mk.mega_chunk_plain(g, cfg, 40)(clone_state(s0))
    return {"cycle 0": s0, "mid-run": mid, "3 before end": late,
            "signed zeros": signed_zeros(torch, mid)}, end


def traced(cfg, spec):
    """``cfg`` with tracing on: ``TRACE_SPECS[spec]``."""
    from repro_torch.telemetry import TelemetrySpec

    return dataclasses.replace(cfg,
                               telemetry=TelemetrySpec(**TRACE_SPECS[spec]))


def check_megakernel(torch, np, graphs, mk, rows):
    """The megakernel chunk against its plain version on clones of one
    state, every leaf and the done trace as bit patterns: every policy x
    eject configuration on the small matrix graph and on n15072, the
    matrix graph on grids above 1024 PEs, and the main-path policies of the
    larger megakernel ``rows``. Every grid runs untraced and traced (the
    trace leaves of its spec in ``TRACE_SPECS`` held bit for bit too).
    Returns the largest abs error and the number of cases, and those of
    the traced variant."""
    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import (OverlayConfig, device_graph,
                                          init_state, run_state)
    from repro_torch.core.partition import build_graph_memory

    b, s, w, seed = MATRIX_GRAPH
    matrix = wl.arrow_lu_graph(b, s, w, seed=seed)
    n15072, _ = graphs.graph("n15072")
    grids = [("matrix 2x2", matrix, 2, 2, POLICIES, EJECTS, "small"),
             ("n15072 16x16", n15072, 16, 16, POLICIES, EJECTS, "default"),
             ("n15072 2x2", n15072, 2, 2, POLICIES, ("n_first_cap1",), None),
             ("matrix 36x36", matrix, 36, 36, ("ooo",), ("n_first_cap1",),
              "partial"),
             ("matrix 42x42", matrix, 42, 42, ("inorder",), ("cap2",),
              "partial"),
             ("matrix 48x48", matrix, 48, 48, ("ooo",), ("n_first_cap1",),
              "small"),
             ("matrix 64x64", matrix, 64, 64, POLICIES, ("n_first_cap1",
                                                         "cap2"), None)]
    if "n470772" in rows:
        grids.append(("n470772 2x2", graphs.graph("n470772")[0], 2, 2,
                      ("ooo", "lru_flat"), ("n_first_cap1",), None))
    err, cases, t_err, t_cases = 0.0, 0, 0.0, 0
    for label, graph, nx, ny, policies, ejects, spec in grids:
        for sched in policies:
            gm = (graphs.memory("n15072", sched) if label == "n15072 16x16"
                  else build_graph_memory(graph, nx, ny,
                                          criticality_order=sched == "ooo"))
            g = device_graph(gm)
            if label in PLANNED_BODIES:
                got = mk.plan(nx, ny, gm.lmax, (sched,))
                if got.body != PLANNED_BODIES[label]:
                    raise AssertionError(f"{label}: the plan gives {got}, "
                                         f"not the {PLANNED_BODIES[label]} "
                                         f"body")
            for eject in ejects:
                t = time.perf_counter()
                cap, pol = EJECTS[eject]
                cfg = OverlayConfig(scheduler=sched, eject_capacity=cap,
                                    eject_policy=pol, engine="megakernel")
                states, end = start_states(torch, mk, g, cfg)
                e, n = compare_chunks(torch, mk, g, cfg, states, (1, 7, 32),
                                      f"{label} {sched} {eject}")
                err, cases = max(err, e), cases + n
                if spec is not None:
                    cfg = traced(cfg, spec)
                    states, _ = start_states(torch, mk, g, cfg)
                    e, n = compare_chunks(torch, mk, g, cfg, states,
                                          (1, 7, 32),
                                          f"{label} {sched} {eject} traced")
                    t_err, t_cases = max(t_err, e), t_cases + n
                print(f"megakernel equals its plain version: {label} {sched} "
                      f"{eject}, W = {gm.lmax // 32}, bodies "
                      f"{bodies(mk, g, (sched,))} (run ends at cycle {end}; 4 "
                      f"states x K in 1, 7, 32)"
                      + (f", untraced and traced ({spec} spec)"
                         if spec else "")
                      + f"; {time.perf_counter() - t:.1f} s", flush=True)
    # The larger main-path rows, at the main path's eject configuration:
    # states made by the plain chunk (40 cycles from cycle 0) and by the
    # engine (half-way to the golden, and 3 cycles before it).
    for name in rows:
        if name == "n15072":
            continue
        for sched, golden in ROWS[name][1].items():
            g = device_graph(graphs.memory(name, sched))
            cfg = OverlayConfig(scheduler=sched, engine="megakernel")
            s0 = init_state(g, cfg)
            half = run_state(g, dataclasses.replace(cfg, max_cycles=golden // 2),
                             clone_state(s0))
            late = run_state(g, dataclasses.replace(cfg, max_cycles=golden - 3),
                             clone_state(half))
            states = {"mid-run": mk.mega_chunk_plain(g, cfg, 40)(s0),
                      "half-way": half, "3 before end": late}
            e, n = compare_chunks(torch, mk, g, cfg, states, (1, 32),
                                  f"{name} {sched}")
            err, cases = max(err, e), cases + n
            print(f"megakernel equals its plain version: {name} {sched} "
                  f"(states at cycles 40, {golden // 2}, {golden - 3}; K in 1, "
                  f"32)", flush=True)
    return err, cases, t_err, t_cases


def timed_chunks(torch, fn, s, n):
    """``n`` calls ``s = fn(s)`` enqueued back to back with a CUDA event
    between two: (median ms between events, median host ms per call)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    host = []
    events[0].record()
    for i in range(n):
        t = time.perf_counter()
        s = fn(s)
        host.append(time.perf_counter() - t)
        events[i + 1].record()
    events[-1].synchronize()
    dev = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return statistics.median(dev), statistics.median(host) * 1e3


def nbytes(tree):
    return sum(nbytes(v) if isinstance(v, dict)
               else v.numel() * v.element_size() for v in tree.values())


def chunk_bytes(g, state, mk, K):
    """Bytes a chunk must move: the graph leaves the kernel reads, read once
    (``fanin``, ``init_value`` and ``valid`` are read only by
    ``init_state``); the state leaves read and written once, but the
    read-only ``sel_lat`` (and a batch's ``policy_id``) only read; the done
    trace written once. A batch's state holds B elements."""
    read_only = {"sel_lat": state["sel_lat"]}
    if "policy_id" in state["sched"]:
        read_only["policy_id"] = state["sched"]["policy_id"]
    return (nbytes({k: g[k] for k in mk.GRAPH_LEAVES}) + 2 * nbytes(state)
            - nbytes(read_only) + K * state["done"].numel())


def trace_bytes(spec, P, start, K):
    """Bytes a traced chunk from cycle ``start`` must move beyond the
    untraced chunk's: the rows of the buckets its K cycles land in, of each
    bucketed leaf, and the total leaves, each read and written once."""
    from repro_torch.telemetry.spec import BUCKETED_LEAVES, GROUPS

    buckets = {min(c // spec.bucket_cycles, spec.buckets - 1)
               for c in range(start, start + K)}
    bucketed = sum(len(BUCKETED_LEAVES.get(g, ())) for g in GROUPS
                   if getattr(spec, g))
    totals = len(spec.leaf_names()) - bucketed
    return 2 * 4 * P * (bucketed * len(buckets) + totals)


def mega_times(torch, graphs, mk, name, policy="ooo", plain_chunks=5,
               telemetry=None, **kw):
    """Per K=32 chunk of ``policy`` from cycle 64: device ms of the kernel
    (``kw`` to ``make_mega_chunk_fn``: a body; traced with ``telemetry``)
    and, with ``plain_chunks``, of its plain version; host ms per kernel
    call, and the bytes bound.

    The chunks are enqueued back to back with a CUDA event between two
    chunks, and a chunk's time is the median interval between its events.
    The host enqueues a kernel chunk faster than the card runs it, so the
    kernel's intervals are its device time; the plain chunk's ~5,600 small
    launches keep the card waiting on the host, so its intervals are the
    host-bound time the card spends on one chunk."""
    from repro_torch.core import overlay

    cfg = overlay.OverlayConfig(scheduler=policy, engine="megakernel",
                                telemetry=telemetry)
    g = overlay.device_graph(graphs.memory(name, policy))
    kernel = mk.make_mega_chunk_fn(g, cfg, MEGA_K, **kw)
    s = kernel(kernel(overlay.init_state(g, cfg)))     # warm-up
    ms, call_ms = timed_chunks(torch, kernel, s, 40)
    plain_ms = None
    if plain_chunks:
        plain = mk.mega_chunk_plain(g, cfg, MEGA_K)
        s = plain(overlay.init_state(g, cfg))
        plain_ms, _ = timed_chunks(torch, plain, s, plain_chunks)
    untraced = overlay.init_state(g, dataclasses.replace(cfg, telemetry=None))
    total = chunk_bytes(g, untraced, mk, MEGA_K)
    if telemetry is not None:
        nx, ny, _ = g["opcode"].shape
        total += trace_bytes(telemetry, nx * ny, 2 * MEGA_K, MEGA_K)
    return dict(ms=ms, plain_ms=plain_ms, call_ms=call_ms, bytes=total,
                shape=list(g["opcode"].shape))


def megakernel_times(torch, graphs, mk):
    """Phase 11: the chunk times of MEGA_TIMED_ROWS x MEGA_TIMED_POLICIES
    (the plain chunk's at the first row's ``ooo``) and of the ``global``
    body at the first row's ``ooo``; then the chunk loop's times. Returns
    {(row, policy, variant): numbers}."""
    out = {}
    first = MEGA_TIMED_ROWS[0]
    runs = [(name, pol, "", {}) for name in MEGA_TIMED_ROWS
            for pol in MEGA_TIMED_POLICIES]
    runs.append((first, "ooo", "global body", dict(body="global")))
    for name, pol, variant, kw in runs:
        plain = 5 if (name, pol, variant) == (first, "ooo", "") else 0
        mt = mega_times(torch, graphs, mk, name, pol, plain, **kw)
        out[name, pol, variant] = mt
        print(f"megakernel time {name} {pol}{' ' + variant if variant else ''} "
              f"{mt['shape']} K={MEGA_K}: device {mt['ms'] * 1e3:.1f} us per "
              f"chunk ({mt['ms'] * 1e3 / MEGA_K:.2f} us per cycle)"
              + (f", plain {mt['plain_ms'] * 1e3:.1f} us per chunk"
                 if mt["plain_ms"] is not None else "")
              + f", host {mt['call_ms'] * 1e3:.1f} us per call, bytes bound "
              f"{mt['bytes'] / HBM_BYTES_PER_S * 1e6:.3f} us "
              f"({mt['bytes']} bytes)", flush=True)
    for name in (first, MEGA_TIMED_ROWS[-1]):
        chunk_loop_times(torch, graphs, mk, name)
    return out


def chunk_loop_times(torch, graphs, mk, name, n=60):
    """The engine's chunk loop (``overlay._run_chunks``) over ``n`` ``ooo``
    chunks with one chunk in flight (the host reads ``done`` after each) and
    with two (the next chunk queued first), in turns, against the same
    chunks launched back to back with no read: wall per chunk."""
    from repro_torch.core import overlay

    cfg = overlay.OverlayConfig(scheduler="ooo", engine="megakernel")
    g = overlay.device_graph(graphs.memory(name, "ooo"))
    chunk = mk.make_mega_chunk_fn(g, cfg, MEGA_K)
    got = {}
    for depth in (1, 2, 2, 1, 0):
        s = chunk(overlay.init_state(g, cfg))   # the leaf check, once
        torch.cuda.synchronize()
        c0 = int(s["cycle"])
        t = time.perf_counter()
        if depth:
            overlay._run_chunks(chunk, s, [c0], [False], [c0 + MEGA_K * n],
                                MEGA_K, depth)
        else:
            for _ in range(n):
                s = chunk(s)
        torch.cuda.synchronize()
        got.setdefault(depth, []).append((time.perf_counter() - t) / n * 1e6)
    print(f"megakernel chunk loop {name} ooo, {n} chunks: one in flight "
          f"{got[1][0]:.1f} / {got[1][1]:.1f} us per chunk, two (queued) "
          f"{got[2][0]:.1f} / {got[2][1]:.1f}, launches alone "
          f"{got[0][0]:.1f}", flush=True)


def batch_state(g, cfgs):
    """(base config, member names, state) of ``cfgs`` as one batch, as
    ``repro_torch.run(gm, batch=cfgs)`` builds them."""
    from repro_torch.core import schedulers
    from repro_torch.core.overlay import init_batch_state

    W = g["opcode"].shape[2] // 32
    names = tuple(dict.fromkeys(c.scheduler for c in cfgs))
    base = dataclasses.replace(cfgs[0], scheduler=names[0], select_latency=None,
                               max_cycles=max(c.max_cycles for c in cfgs))
    state = init_batch_state(
        g, base, names, [names.index(c.scheduler) for c in cfgs],
        [schedulers.get(c.scheduler).sel_lat(c, W) for c in cfgs])
    return base, names, state


def mixed_batch(cap, pol, budget=100, telemetry=None):
    """All four policies, ``ooo`` at select latency 4 and ``scan`` with a
    short budget, at one eject configuration (traced with ``telemetry``)."""
    from repro_torch.core.overlay import OverlayConfig

    kw = dict(eject_capacity=cap, eject_policy=pol, engine="megakernel",
              telemetry=telemetry)
    return [OverlayConfig(scheduler=p, **kw) for p in BATCH_POLICIES] + [
        OverlayConfig(scheduler="ooo", select_latency=4, **kw),
        OverlayConfig(scheduler="scan", max_cycles=budget, **kw)]


def compare_batch_chunks(torch, mk, g, base, names, states, ks, label,
                         max_cycles=None):
    """The batched kernel chunk of each body (``bodies``) against its plain
    version on clones of each state: every leaf and the [K, B] trace equal
    as bit patterns."""
    err, cases = 0.0, 0
    for sname, st in states.items():
        for K in ks:
            want, want_tr = mk.mega_batch_chunk_plain(
                g, base, K, names, with_trace=True,
                max_cycles=max_cycles)(clone_state(st))
            for body in bodies(mk, g, names):
                got, got_tr = mk.make_mega_chunk_fn(
                    g, base, K, names=names, with_trace=True,
                    max_cycles=max_cycles, body=body)(clone_state(st))
                torch.cuda.synchronize()
                err = max(err, state_err(torch, got, want))
                if not torch.equal(got_tr, want_tr):
                    raise AssertionError(f"batched megakernel done trace "
                                         f"differs: {label} {sname} K={K} "
                                         f"{body}")
                cases += 1
    return err, cases


def main_path_batches(graphs, rows):
    """The batches that phases 8, 9 and 12 run on the card, plus all four
    policies as one batch on the largest row's node-id layout (several
    members at the largest L): [(label, GraphMemory, configs)]."""
    from repro_torch.core.overlay import OverlayConfig

    batches = []
    for name in rows:
        for group in layout_groups(ROWS[name][1]):
            batches.append((f"{name} {'+'.join(group)}",
                            graphs.memory(name, group[0]),
                            [OverlayConfig(scheduler=p, engine="megakernel")
                             for p in group]))
    largest = rows[-1]
    batches.append((f"{largest} {'+'.join(POLICIES)} (node-id layout)",
                    graphs.memory(largest, "inorder"),
                    [OverlayConfig(scheduler=p, engine="megakernel")
                     for p in POLICIES]))
    for sweep, (layout, _, _) in SWEEPS.items():
        batches.append((f"{SWEEP_ROW} {sweep}", graphs.memory(SWEEP_ROW, layout),
                        sweep_configs(sweep)))
    return batches


def check_batched_megakernel(torch, graphs, mk, rows):
    """The batched kernel against its plain version. A mixed batch on the
    matrix graph (2x2) and on n15072 (16x16), every eject configuration,
    four start states, K = 1, 7, 32, and a one-cycle tail launch with
    elements frozen at their budgets. Then every batch that the main path
    and the sweeps run (``main_path_batches``): from each element half-way
    to its end, three cycles before it, and (where the ends differ) three
    cycles before the last end with the other elements done, at K = 1 and
    32 (K = 1 and 7 above SMALL_B elements), and a tail launch that freezes
    every other element. The mixed batches also run traced (the ``small``
    spec on the matrix graph, every eject configuration; the ``default`` on
    n15072 at n_first). Returns
    (max abs error, cases) and those of the traced variant."""
    from repro_torch.core.overlay import device_graph, run_batch_state
    from repro_torch.telemetry import TelemetrySpec

    memories = {"matrix 2x2": (matrix_memory(2, 2, True), "small"),
                "n15072 16x16": (graphs.memory("n15072", "ooo"), "default")}
    err, cases, t_err, t_cases = 0.0, 0, 0.0, 0
    runs = [(label, gm, eject, spec) for label, (gm, traced_spec)
            in memories.items() for eject in EJECTS
            for spec in (None, traced_spec)
            if spec is None or label == "matrix 2x2"
            or eject == "n_first_cap1"]
    for label, gm, eject, spec in runs:
        t = time.perf_counter()
        g = device_graph(gm)
        cap, pol = EJECTS[eject]
        cfgs = mixed_batch(cap, pol, telemetry=spec and TelemetrySpec(
            **TRACE_SPECS[spec]))
        base, names, s0 = batch_state(g, cfgs)
        budgets = [c.max_cycles for c in cfgs]
        ends = run_batch_state(g, base, names, clone_state(s0),
                               budgets)["cycle"].tolist()
        late = run_batch_state(
            g, base, names, clone_state(s0),
            [min(m, e - 3) for m, e in zip(budgets, ends)])
        mid = mk.mega_batch_chunk_plain(g, base, 40, names)(
            clone_state(s0))
        states = {"cycle 0": s0, "mid-run": mid, "3 before each end": late,
                  "signed zeros": signed_zeros(torch, mid)}
        e, n = compare_batch_chunks(torch, mk, g, base, names, states,
                                    (1, 7, 32), f"{label} {eject}")
        # The tail: elements at budgets 40 (= their cycle) freeze.
        frozen = torch.tensor([40, 10_000, 41, 40, 10_000, 100],
                              dtype=torch.int32, device=g["opcode"].device)
        e2, n2 = compare_batch_chunks(torch, mk, g, base, names,
                                      {"tail": mid}, (1,),
                                      f"{label} {eject}", max_cycles=frozen)
        if spec is None:
            err, cases = max(err, e, e2), cases + n + n2
        else:
            t_err, t_cases = max(t_err, e, e2), t_cases + n + n2
        print(f"batched megakernel equals its plain version: {label} "
              f"{eject}{f' traced ({spec} spec)' if spec else ''}, B = "
              f"{len(cfgs)} (elements end at cycles {ends}; 4 states x K "
              f"in 1, 7, 32, and a tail launch); "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    for label, gm, cfgs in main_path_batches(graphs, rows):
        g = device_graph(gm)
        base, names, s0 = batch_state(g, cfgs)
        budgets = [c.max_cycles for c in cfgs]
        ends = run_batch_state(g, base, names, clone_state(s0),
                               budgets)["cycle"].tolist()
        half = run_batch_state(g, base, names, clone_state(s0),
                               [e // 2 for e in ends])
        late = run_batch_state(g, base, names, clone_state(half),
                               [e - 3 for e in ends])
        states = {"half-way": half, "3 before each end": late}
        if len(set(ends)) > 1:   # the elements that end first are done
            states["3 before the last end"] = run_batch_state(
                g, base, names, clone_state(half), [max(ends) - 3] * len(cfgs))
        ks = (1, 32) if len(cfgs) <= SMALL_B else (1, 7)
        e, n = compare_batch_chunks(torch, mk, g, base, names, states, ks,
                                    label)
        frozen = late["cycle"] + torch.arange(
            len(cfgs), dtype=torch.int32, device=g["opcode"].device) % 2
        e2, n2 = compare_batch_chunks(torch, mk, g, base, names,
                                      {"tail": late}, (1,), label,
                                      max_cycles=frozen)
        err, cases = max(err, e, e2), cases + n + n2
        print(f"batched megakernel equals its plain version: {label}, B = "
              f"{len(cfgs)}, members {names} (elements end at cycles "
              f"{min(ends)}..{max(ends)}; {len(states)} states x K in {ks}, "
              f"and a tail launch)", flush=True)
    return err, cases, t_err, t_cases


def compare_replayed(torch, make, states, ks, label):
    """For each K: the chunk ``make(K)`` replayed from a captured CUDA graph
    (``overlay.ReplayedChunk``; captured on a clone of the first state, each
    later state's clone copied in) against the eager chunk ``make(K)`` on
    another clone of each state: every leaf and the done trace equal as bit
    patterns. Returns (largest abs error, cases)."""
    from repro_torch.core import overlay

    err, cases = 0.0, 0
    for K in ks:
        replayed = overlay.ReplayedChunk(make(K), label)
        for sname, st in states.items():
            want, want_tr = make(K)(clone_state(st))
            got, got_tr = replayed(clone_state(st))
            torch.cuda.synchronize()
            err = max(err, state_err(torch, got, want))
            if not torch.equal(got_tr, want_tr):
                raise AssertionError(f"replayed chunk's done trace differs: "
                                     f"{label} {sname} K={K}")
            cases += 1
    return err, cases


def check_replayed_chunks(torch, graphs, mk):
    """Phase 5b: the ``tensor`` and ``select`` engines' chunk replayed from
    its captured CUDA graph against the eager chunk (``make_chunk_fn``,
    ``make_batch_chunk_fn``) on clones of one state: both engines, every
    policy x eject configuration on the matrix graph (2x2) and on n15072
    (16x16) from phase 4's four states, and phase 10's mixed batch on the
    matrix graph (each eject configuration; cycle 0, mid-run, three cycles
    before each element's end, signed zeros), at K = 7 and the engine's own
    K. Traced too, at n_first: every policy on the matrix graph and the
    mixed batch (the ``small`` spec) and n15072 ``ooo`` (the ``default``
    spec), so the capture records the trace updates. Returns
    (largest abs error, cases) and those of the traced chunks."""
    from repro_torch.core import overlay, schedulers
    from repro_torch.core.overlay import device_graph, resolve_check_every

    def ks(g, cfg):
        nx, ny, L = g["opcode"].shape
        own = resolve_check_every(dataclasses.replace(cfg, engine="select"),
                                  nx, ny, L, device_type="cuda")
        return sorted({7, own})      # the tensor engine's K on the card too

    err, cases, t_err, t_cases = 0.0, 0, 0.0, 0
    for label in ("matrix 2x2", "n15072 16x16"):
        for sched in POLICIES:
            gm = (graphs.memory("n15072", sched) if label == "n15072 16x16"
                  else matrix_memory(2, 2, sched == "ooo"))
            g = device_graph(gm)
            for eject, (cap, pol) in EJECTS.items():
                t = time.perf_counter()
                mega = overlay.OverlayConfig(
                    scheduler=sched, eject_capacity=cap, eject_policy=pol,
                    engine="megakernel")
                specs = [None]
                if eject == "n_first_cap1" and label == "matrix 2x2":
                    specs.append("small")
                elif eject == "n_first_cap1" and sched == "ooo":
                    specs.append("default")
                for spec in specs:
                    run_cfg = mega if spec is None else traced(mega, spec)
                    states, _ = start_states(torch, mk, g, run_cfg)
                    for engine in ("tensor", "select"):
                        cfg = dataclasses.replace(run_cfg, engine=engine)
                        cycle = overlay.make_cycle_fn(g, cfg)
                        e, n = compare_replayed(
                            torch, lambda k: overlay.make_chunk_fn(
                                cycle, k, with_trace=True),
                            states, ks(g, cfg),
                            f"{label} {sched} {eject} {engine} {spec}")
                        if spec is None:
                            err, cases = max(err, e), cases + n
                        else:
                            t_err, t_cases = max(t_err, e), t_cases + n
                print(f"replayed chunk equals the eager chunk: {label} "
                      f"{sched} {eject}, tensor and select, 4 states x K in "
                      f"{ks(g, mega)}, untraced"
                      + (f" and traced ({specs[1]} spec)"
                         if len(specs) > 1 else "")
                      + f"; {time.perf_counter() - t:.1f} s", flush=True)
    g = device_graph(matrix_memory(2, 2, True))
    runs = [(eject, None) for eject in EJECTS] + [("n_first_cap1", "small")]
    for eject, spec in runs:
        cap, pol = EJECTS[eject]
        cfgs = select_batch("megakernel", cap, pol)
        if spec is not None:
            cfgs = [traced(c, spec) for c in cfgs]
        base, names, s0 = batch_state(g, cfgs)
        budgets = [c.max_cycles for c in select_batch("megakernel")]
        ends = overlay.run_batch_state(g, base, names, clone_state(s0),
                                       budgets)["cycle"].tolist()
        late = overlay.run_batch_state(
            g, base, names, clone_state(s0),
            [min(m, e - 3) for m, e in zip(budgets, ends)])
        mid = mk.mega_batch_chunk_plain(g, base, 40, names)(clone_state(s0))
        states = {"cycle 0": s0, "mid-run": mid, "3 before each end": late,
                  "signed zeros": signed_zeros(torch, mid)}
        for engine in ("tensor", "select"):
            cfg = dataclasses.replace(base, engine=engine)
            cycle = overlay.make_cycle_fn(
                g, cfg, scheduler=schedulers.BatchedScheduler(names))
            e, n = compare_replayed(
                torch, lambda k: overlay.make_batch_chunk_fn(
                    cycle, k, with_trace=True),
                states, ks(g, cfg), f"mixed batch {eject} {engine} {spec}")
            if spec is None:
                err, cases = max(err, e), cases + n
            else:
                t_err, t_cases = max(t_err, e), t_cases + n
        print(f"replayed batched chunk equals the eager chunk: matrix 2x2 "
              f"{eject}{f' traced ({spec} spec)' if spec else ''}, B = "
              f"{len(budgets)} (elements end at cycles {ends}), tensor and "
              f"select, 4 states x K in {ks(g, base)}", flush=True)
    return err, cases, t_err, t_cases


def batch_chunk_ms(torch, mk, g, cfgs):
    """Device and host ms per K=32 batched chunk of ``cfgs`` from cycle 0
    (after two warm-up chunks), and the chunk's bytes bound in bytes."""
    base, names, s0 = batch_state(g, cfgs)
    total = chunk_bytes(g, s0, mk, MEGA_K)
    chunk = mk.make_mega_chunk_fn(g, base, MEGA_K, names=names)
    ms, call_ms = timed_chunks(torch, chunk, chunk(chunk(s0)), 40)
    return ms, call_ms, total


def batch_scaling(torch, graphs, mk, solo_walls=None):
    """The first B configs of sweep_ooo for B in SCALING_B: wall and summed
    simulated cycles per second of ``run(batch=)``, the same B solo runs'
    summed wall (where ``solo_walls`` has them), device and host ms per K=32
    batched chunk from cycle 0, its bytes bound and the run's kernel
    launches; at BATCH_TIMED_B the plain batched chunk too. Then the same
    chunk times of two batches with three member policies at n29772:
    ``policy_sweep`` (B = 3) and ``sweep_mixed`` (B = 126). Returns {B:
    numbers}."""
    import repro_torch
    from repro_torch.core.overlay import OverlayConfig, device_graph

    gm = graphs.memory(SWEEP_ROW, SWEEPS["sweep_ooo"][0])
    g = device_graph(gm)
    all_cfgs = sweep_configs("sweep_ooo")
    out = {}
    for B in SCALING_B:
        cfgs = all_cfgs[:B]
        mk.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        rs = repro_torch.run(gm, batch=cfgs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = mk.launches["mega_chunk_batched"]
        ms, call_ms, total = batch_chunk_ms(torch, mk, g, cfgs)
        n = dict(B=B, wall=wall, cycles=sum(r.cycles for r in rs),
                 solo_wall=sum(solo_walls[:B]) if solo_walls else None, ms=ms,
                 call_ms=call_ms, bytes=total, launches=launches,
                 shape=[B, *g["opcode"].shape])
        if B == BATCH_TIMED_B:
            base, names, s0 = batch_state(g, cfgs)
            plain = mk.mega_batch_chunk_plain(g, base, MEGA_K, names)
            n["plain_ms"], _ = timed_chunks(torch, plain, plain(s0), 2)
        out[B] = n
        print(f"batch scaling {SWEEP_ROW} sweep_ooo B = {B}: wall "
              f"{wall:.3f} s, {n['cycles'] / wall:.0f} simulated cycles/s "
              f"summed over elements ({n['cycles']} cycles); "
              + (f"{B} solo runs {n['solo_wall']:.3f} s; "
                 if solo_walls else "")
              + f"device {ms * 1e3:.1f} us per K="
              f"{MEGA_K} chunk, host {call_ms * 1e3:.1f} us per call, bytes "
              f"bound {n['bytes'] / HBM_BYTES_PER_S * 1e6:.3f} us "
              f"({n['bytes']} bytes); {launches} mega_chunk_batched launches"
              + (f"; plain batched chunk {n['plain_ms']:.1f} ms"
                 if "plain_ms" in n else ""), flush=True)
    layout, policies, _ = SWEEPS["sweep_mixed"]
    g = device_graph(graphs.memory(SWEEP_ROW, layout))
    for label, cfgs in (
            ("policy_sweep", [OverlayConfig(scheduler=p, engine="megakernel")
                              for p in policies]),
            ("sweep_mixed", sweep_configs("sweep_mixed"))):
        ms, call_ms, total = batch_chunk_ms(torch, mk, g, cfgs)
        print(f"batch chunk {SWEEP_ROW} {label} B = {len(cfgs)} (members "
              f"{policies}): device {ms * 1e3:.1f} us per K={MEGA_K} chunk, "
              f"host {call_ms * 1e3:.1f} us per call, bytes bound "
              f"{total / HBM_BYTES_PER_S * 1e6:.3f} us ({total} bytes)",
              flush=True)
    return out


def profile_run(torch, run, cycles, label, unit="cycle"):
    """Device busy share, device ops per ``unit`` and top kernels of
    ``run()`` (which runs ``cycles`` units: simulated cycles, or serve
    steps) under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    run()   # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t
    # Device-side events only: the kernels (and copies) that ran on the card.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    print(f"profile {label}, {cycles} {unit}s: wall {wall * 1e3:.1f} ms "
          f"untraced ({wall / cycles * 1e3:.4f} ms/{unit}), "
          f"{traced_wall * 1e3:.1f} ms traced; device busy "
          f"{device_us / 1e3:.2f} ms = {device_us / (wall * 1e6):.4f} of the "
          f"untraced wall; {launches} device ops "
          f"({launches / cycles:.2f}/{unit})",
          flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms {e.count:7d}x  "
              f"{e.key[:100]}", flush=True)
    return {e.key: (e.self_device_time_total, e.count) for e in kernels}


def kernel_node_us(kernels, name):
    """Mean device us per launch of the kernels whose name holds ``name``,
    from ``profile_run``'s table, and the launches it averaged."""
    hits = [(us, n) for key, (us, n) in kernels.items() if name in key]
    total, count = sum(u for u, _ in hits), sum(n for _, n in hits)
    return (total / count if count else None), count


#: Profiler names of the leading-one kernels (``csrc/lod.cu``).
LOD_KERNELS = {"schedule_step": "lod_schedule_kernel",
               "rotating_schedule_step": "lod_rotating_kernel"}
#: The replayed chunk loops profiled: (row, policy, engine). ``ooo`` picks
#: through kernel 2, ``lru_flat`` through kernel 3 (at n29772, where the
#: main path runs it).
REPLAY_PROFILES = (("n15072", "ooo", "select"), ("n29772", "lru_flat", "select"),
                   ("n15072", "ooo", "tensor"))
#: Chunks per profiled window of a replayed chunk loop.
REPLAY_CHUNKS = 20


def replay_profile(torch, graphs, name, policy, engine):
    """The engine's chunk (``make_engine_chunk_fn``: a ``ReplayedChunk``)
    captured once from cycle 0, then REPLAY_CHUNKS replays back to back
    (the host's read of ``done`` left out): device and host time per chunk
    (CUDA events between chunks; the host's time per call), and the
    profile of such a window (busy share, ops per cycle, each leading-one
    kernel's device us per launch). Returns the numbers."""
    from repro_torch.core import overlay

    cfg = overlay.OverlayConfig(scheduler=policy, engine=engine)
    g = overlay.device_graph(graphs.memory(name, policy))
    nx, ny, L = g["opcode"].shape
    K = overlay.resolve_check_every(cfg, nx, ny, L, device_type="cuda")
    chunk = overlay.make_engine_chunk_fn(g, cfg, K)
    s = chunk(overlay.init_state(g, cfg))          # capture + first replay
    torch.cuda.synchronize()
    ms, host_ms = timed_chunks(torch, chunk, s, REPLAY_CHUNKS)
    label = f"{name} {policy} {engine}, K={K}"
    print(f"replayed chunk {label}: device {ms * 1e3:.1f} us per chunk "
          f"({ms * 1e3 / K:.2f} us per cycle, {K / ms * 1e3:.0f} cycles/s), "
          f"host {host_ms * 1e3:.1f} us per replay call; launches per replay "
          f"{chunk.per_replay}", flush=True)
    kernels = profile_run(torch, lambda: [chunk(s) for _ in range(REPLAY_CHUNKS)],
                          REPLAY_CHUNKS * K,
                          f"{label} chunk loop ({REPLAY_CHUNKS} replays)")
    nodes = {k: kernel_node_us(kernels, v) for k, v in LOD_KERNELS.items()}
    per_replay = sum(n for _, n in kernels.values()) / REPLAY_CHUNKS
    print(f"replayed chunk {label}: {per_replay:.0f} device ops a replay, "
          f"host {host_ms * 1e3 / per_replay:.3f} us per op", flush=True)
    return dict(K=K, ms=ms, host_ms=host_ms, per_replay=chunk.per_replay,
                nodes=nodes, ops_per_replay=per_replay)


def profiles(torch, graphs):
    """Phase 13. Returns {kernel: (node us, profiled launches)} from the
    replayed select chunk loops, and each replay profile's numbers."""
    import repro_torch
    from repro_torch.core import overlay
    from repro_torch.core.overlay import OverlayConfig

    gm = graphs.memory("n15072", "ooo")
    golden = ROWS["n15072"][1]["ooo"]
    nodes, replays = {}, {}
    cycles = REPLAY_CHUNKS * 16
    cfg = OverlayConfig(scheduler="ooo", engine="select", max_cycles=cycles)
    profile_run(torch, lambda: repro_torch.run(gm, cfg), cycles,
                f"n15072 ooo select (first {cycles} cycles: set-up, the "
                f"capture and {REPLAY_CHUNKS} replays)")
    # The main path's chunk loop alone (run_state on a state built
    # beforehand): the capture, the replays with the host's read of `done`
    # after each, and the eager tail.
    select = OverlayConfig(scheduler="ooo", engine="select")
    g = overlay.device_graph(gm)
    built = [overlay.init_state(g, select) for _ in range(3)]
    torch.cuda.synchronize()
    profile_run(torch, lambda: overlay.run_state(g, select, built.pop()),
                golden, "n15072 ooo select (chunk loop: run_state on a built "
                "state)")
    for name, policy, engine in REPLAY_PROFILES:
        out = replay_profile(torch, graphs, name, policy, engine)
        replays[name, policy, engine] = out
        for k, (us, count) in out["nodes"].items():
            if count and k not in nodes:
                nodes[k] = (us, count)
    for k, (us, count) in nodes.items():
        print(f"{k} node in the replayed chunk: {us:.3f} us per launch "
              f"({count} launches profiled)", flush=True)
    mega = OverlayConfig(scheduler="ooo", engine="megakernel")
    profile_run(torch, lambda: repro_torch.run(gm, mega), golden,
                "n15072 ooo megakernel (whole run)")
    # The chunk loop alone (run_state on a state built beforehand): the
    # queued chunks without the run's set-up (graph upload, init_state,
    # result unpacking).
    states = [overlay.init_state(g, mega) for _ in range(3)]
    torch.cuda.synchronize()
    profile_run(torch, lambda: overlay.run_state(g, mega, states.pop()),
                golden, "n15072 ooo megakernel (chunk loop: run_state on a "
                "built state)")
    # The largest row, where the run's set-up is a small share of its wall.
    big = "n470772"
    profile_run(torch, lambda: repro_torch.run(graphs.memory(big, "ooo"), mega),
                ROWS[big][1]["ooo"], f"{big} ooo megakernel (whole run)")
    return nodes, replays


# ---------------------------------------------------------------------------
# The LM serving path and the flash-attention kernel.
# ---------------------------------------------------------------------------

FLASH_REPLACES = "src/repro/kernels/flash_attention.py:75"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), FLOP/s.
BF16_FLOPS_PER_S = 989e12
#: The serve main path: qwen2-0.5b at full width, bf16, batch 8 x 2048
#: prompt tokens, 32 new tokens (one prefill and 31 decode steps).
SERVE_ARGS = ["--arch", "qwen2-0.5b", "--batch", "8", "--prompt-len", "2048",
              "--gen", "32"]
SERVE_LAUNCHES = 24 * 32
#: Launches of each body of the kernel in the counted serve run: the
#: prefill's 24 layers on the tensor cores, 31 decode steps x 24 layers
#: split over the keys, each followed by its combine.
SERVE_BODIES = {"flash_attention_mma": 24, "flash_attention_split": 24 * 31,
                "flash_attention_combine": 24 * 31, "flash_attention_simt": 0}
#: Kernel checks: name -> (b, hq, hkv, tq, tkv, d, causal, kv_len, layout,
#: (body in float32, body in bfloat16)). The reference's five kernel-test
#: shapes (tests/test_kernels.py, in the Pallas kernel's [B, H, T, D]
#: layout), the main path's prefill and decode (ragged cache fill levels, 1,
#: 64, 65 and Tkv among them), gemma-2b's head_dim 256 under MQA, and the
#: tensor-core body at awkward shapes: Tq not a multiple of 64 (33, 2047),
#: Tkv not a multiple of the key tile (70, 2049), head_dim 80, 128 and 256,
#: non-causal (whisper's cross-attention form), Tq < Tkv, ragged kv_len.
#: Each runs in float32 and bfloat16 and must take the body named.
PREFILL, DECODE = ("simt", "mma"), ("split", "split")
FLASH_CASES = {
    "test_kernels_1": (2, 4, 2, 128, 128, 64, True, None, "heads", PREFILL),
    "test_kernels_2": (1, 2, 1, 64, 256, 128, True, None, "heads", PREFILL),
    "test_kernels_3": (1, 4, 4, 128, 128, 80, False, None, "heads", PREFILL),
    "test_kernels_4": (2, 2, 2, 96, 160, 64, True, None, "heads", PREFILL),
    "test_kernels_5": (1, 2, 2, 128, 128, 64, True, None, "heads", PREFILL),
    "qwen2_prefill": (8, 14, 2, 2048, 2048, 64, True, None, "tokens", PREFILL),
    "qwen2_decode": (8, 14, 2, 1, 2080, 64, True,
                     [1, 2080, 2049, 1500, 777, 64, 65, 2079], "tokens",
                     DECODE),
    "gemma_mqa_prefill": (2, 8, 1, 256, 256, 256, True, None, "tokens",
                          PREFILL),
    "gemma_mqa_decode": (4, 8, 1, 1, 300, 256, True, [1, 300, 129, 64],
                         "tokens", DECODE),
    "tq33_tkv70": (2, 14, 2, 33, 70, 64, True, None, "tokens", PREFILL),
    "tq2047_tkv2049": (1, 14, 2, 2047, 2049, 64, True, None, "tokens",
                       PREFILL),
    "d80_noncausal_ragged": (2, 6, 2, 100, 70, 80, False, [70, 33], "tokens",
                             PREFILL),
    "d128_ragged": (3, 8, 2, 70, 2049, 128, True, [70, 2049, 1000], "tokens",
                    PREFILL),
    "d256_gqa": (1, 4, 2, 130, 200, 256, True, None, "heads", PREFILL),
    "whisper_cross": (1, 20, 20, 64, 1500, 64, False, None, "tokens",
                      PREFILL),
    "decode_kv_edges": (4, 14, 2, 1, 2080, 64, True, [1, 64, 65, 2080],
                        "tokens", DECODE),
    "decode_tq2": (2, 14, 2, 2, 300, 64, True, [2, 300], "tokens", DECODE),
    "decode_mqa_d80": (3, 8, 1, 1, 129, 80, True, [1, 65, 129], "tokens",
                       DECODE),
}
#: Tolerances against the plain version: in float32 the two differ only in
#: the order of f32 sums; bfloat16 is the reference's kernel-test tolerance
#: (tests/test_kernels.py:135). Each holds twice: as rtol = atol, and per
#: output row (one (b, t, h) over D) as |got - want| <= tol * (|want| +
#: the row's RMS), which a row averaging over ~1000 keys (RMS ~ 0.03) would
#: fail if a key tile went missing.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: Timed shapes (bfloat16, the serve path's type): name -> case.
FLASH_TIMED = {"prefill": "qwen2_prefill", "decode": "qwen2_decode"}
#: The decode timing reads a full cache: kv_len = Tkv for every row.
DECODE_TIMED_KV_LEN = 2080
#: Consistency at full width (f32): batch, prompt, teacher-forced steps;
#: the reference's serving-test tolerance (tests/test_serving.py:13).
CONSIST = (2, 32, 16)
CONSIST_TOL = 3e-4
GOLDEN = ROOT / "tests" / "fixtures" / "qwen2_0_5b_golden.npz"
#: Port (f32 on the card, TF32 off) against the reference's golden logits
#: (f32 on a CPU): rtol = atol. The port on the CPU is within 3.4e-6 of it.
GOLDEN_TOL = 1e-4
GOLDEN_BF16 = GOLDEN.with_name("qwen2_0_5b_golden_bf16.npz")
#: Port in bf16 on the card against the reference in bf16 (XLA on a CPU),
#: per row as a share of |golden| + the row's RMS over the vocabulary
#: (~0.6). bf16 keeps 8 significant bits (a relative step of 2^-8 = 3.9e-3),
#: and the two round at other places: cuBLAS and eager torch round each
#: op's output, XLA rounds once per fused chain, the mma body rounds P to
#: bf16. On an H100 (80GB HBM3, 700 W) the clean port reads 0.0127, and
#: the causal mask dropped in one of the 24 prefill layers reads 0.0312:
#: the limit sits between the two, ~1.6x from each, so that a fault of the
#: attention in one layer fails the check.
GOLDEN_BF16_TOL = 2e-2


def flash_inputs(torch, case, dtype, seed):
    b, hq, hkv, tq, tkv, d = FLASH_CASES[case][:6]
    g = torch.Generator("cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((b, tq, hq, d), (b, tkv, hkv, d), (b, tkv, hkv, d))]


def body_launches(body):
    """The launch counts of one call that takes ``body``."""
    want = {k: 0 for k in ("flash_attention_mma", "flash_attention_split",
                           "flash_attention_combine", "flash_attention_simt")}
    want["flash_attention"] = 1
    want[f"flash_attention_{body}"] = 1
    if body == "split":
        want["flash_attention_combine"] = 1
    return want


def check_flash(torch, fa):
    """The kernel against its plain version on every case, both dtypes, and
    the body each case must take. Returns the largest error over the cases
    and that of each body."""
    worst, by_body = 0.0, {}
    for i, (case, (b, hq, hkv, tq, tkv, d, causal, kv_len, layout, bodies)) \
            in enumerate(FLASH_CASES.items()):
        for dtype, body in zip((torch.float32, torch.bfloat16), bodies):
            q, k, v = flash_inputs(torch, case, dtype, seed=i)
            want = fa.attention_plain(q, k, v, causal=causal, kv_len=kv_len)
            fa.reset_launches()
            if layout == "heads":       # the Pallas kernel's [B, H, T, D]
                heads = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
                got = fa.flash_attention(*heads, causal=causal,
                                         kv_len=kv_len).transpose(1, 2)
            else:
                got = fa.attention(q, k, v, causal=causal, kv_len=kv_len)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            rms = want.float().pow(2).mean(-1, keepdim=True).sqrt()
            row_err = (diff / (want.float().abs() + rms)).max().item()
            tol = FLASH_TOL[str(dtype).split(".")[-1]]
            print(f"flash_attention {case} {str(dtype)[6:]} {body} "
                  f"b={b} hq={hq} hkv={hkv} tq={tq} tkv={tkv} d={d} "
                  f"causal={causal} kv_len={kv_len}: max abs error vs plain "
                  f"{err:.3e}, row-scaled {row_err:.3e} (tol {tol})",
                  flush=True)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            if not row_err <= tol:
                raise AssertionError(f"{case} {dtype}: error {row_err} of "
                                     f"|want| + the row's RMS above {tol}")
            if got.dtype != dtype or got.shape != q.shape:
                raise AssertionError(f"{case}: output {got.dtype} "
                                     f"{tuple(got.shape)}")
            if fa.launches != body_launches(body):
                raise AssertionError(f"{case} {dtype}: launches "
                                     f"{fa.launches}, want the {body} body")
            worst = max(worst, err)
            key = f"{body}_{str(dtype)[6:]}"
            by_body[key] = max(by_body.get(key, 0.0), err)
    print(f"flash_attention max abs error by body: {by_body}", flush=True)
    return worst, by_body


def ex2_error(torch, fa):
    """The mma body's exponential (ex2.approx of scores times scale * log2 e)
    against expf on the scores of the main path's prefill case (batch row
    0, every q head, the causal pairs; raw q . k in f32 from the bf16
    inputs): the largest absolute and relative error of p = exp(scale * (s
    - row max)), which the body then rounds to bf16 (a relative step of
    2^-8). Fails above half that step."""
    from repro_torch.kernels import _build

    case = FLASH_TIMED["prefill"]
    _, hq, hkv, tq, tkv, d = FLASH_CASES[case][:6]
    q, k, _ = flash_inputs(torch, case, torch.bfloat16, seed=99)
    qf = q[0].float().transpose(0, 1)                           # [Hq, Tq, D]
    kf = k[0].float().transpose(0, 1).repeat_interleave(hq // hkv, 0)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    s = torch.matmul(qf, kf.transpose(1, 2))                    # [Hq, Tq, Tkv]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    s.masked_fill_(torch.ones(tq, tkv, dtype=torch.bool, device="cuda")
                   .triu(tkv - tq + 1), float("-inf"))
    mx = s.amax(-1).contiguous()
    out = torch.zeros(2, dtype=torch.int32, device="cuda")
    rc = _build.library(fa.SOURCE).flash_attention_ex2_error(
        s.data_ptr(), mx.data_ptr(), tkv, s.numel(), 1.0 / math.sqrt(d),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_ex2_error failed: CUDA error {rc}")
    abs_err, rel_err = out.cpu().view(torch.float32).tolist()
    pairs = int(torch.isfinite(s).sum().item())
    print(f"flash_attention ex2 vs expf on {case}'s scores (batch row 0, "
          f"{pairs} causal pairs): p max abs error {abs_err:.3e}, max "
          f"relative error {rel_err:.3e} (bf16 P's relative step 2^-8 = "
          f"{2 ** -8:.3e})", flush=True)
    if not rel_err <= 2 ** -9:
        raise AssertionError(f"ex2 relative error {rel_err} above 2^-9")
    return abs_err, rel_err


def flash_work(case, kv_len, elem):
    """(FLOPs, bytes) the function needs: 4 * D per visible (row, key)
    pair and q head; q, k, v read once and o written once."""
    b, hq, hkv, tq, tkv, d, causal = FLASH_CASES[case][:7]
    lens = [kv_len] * b if isinstance(kv_len, int) else kv_len
    pairs = 0
    for n in lens:
        for i in range(tq):
            pairs += min(n, i + n - tq + 1) if causal else n
    flops = 4 * d * hq * pairs
    nbytes = elem * (2 * b * tq * hq * d + 2 * sum(lens) * hkv * d)
    return flops, nbytes


def sdpa_inputs(torch, q, k, v, causal, lens):
    """Contiguous [B, H, T, D] copies and the explicit boolean mask of the
    ends-aligned causal and kv_len bounds, for the library yardstick."""
    b, tq, tkv = q.shape[0], q.shape[1], k.shape[1]
    n = torch.tensor(lens, device="cuda")[:, None, None]
    kpos = torch.arange(tkv, device="cuda")[None, None, :]
    mask = kpos < n
    if causal:
        qpos = torch.arange(tq, device="cuda")[None, :, None]
        mask = mask & (kpos <= qpos + n - tq)
    return ([x.transpose(1, 2).contiguous() for x in (q, k, v)],
            mask[:, None])                                  # [B, 1, Tq, Tkv]


#: Kernel names of the bodies, as the profiler shows them.
FLASH_KERNELS = ("mma_kernel", "split_kernel", "combine_kernel", "simt_kernel")


def kernel_us(torch, fn, n=20, names=FLASH_KERNELS, warmup=True):
    """Device us per launch of each kernel of ``names`` (by default the
    flash bodies') that ``fn`` launches, from ``torch.profiler`` over ``n``
    calls (averaged over the launches the profiler recorded, which may be
    fewer than ``n``), after one call unprofiled unless ``warmup`` is
    false."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in names:
            if name in e.key:
                total[name] = total.get(name, 0.0) + e.self_device_time_total
                count[name] = count.get(name, 0) + e.count
    return {name: total[name] / count[name] for name in total}


def host_ms(torch, fn, n=100, rounds=7):
    """Host ms per call: ``n`` calls enqueued without a synchronisation
    (the card keeps up), median over ``rounds``."""
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t) / n * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def flash_times(torch, fa):
    """Device ms of the kernel, its plain version and SDPA (one PyTorch call
    computing the same function, the yardstick; the port never calls it) at
    the main path's prefill and decode shapes in bfloat16, beside the
    bound. The kernel and SDPA are replayed from a CUDA graph; the plain
    version (which copies kv_len to the card, so it cannot be captured) is
    timed call by call from the host. Host ms per kernel call too, and each
    body kernel's device us from the profiler; at the prefill shape also in
    float32, where the plan takes the simt body."""
    import torch.nn.functional as F

    out = {}
    for label, case in FLASH_TIMED.items():
        b, hq, hkv, tq, tkv, d, causal = FLASH_CASES[case][:7]
        kv_len = tkv if label == "prefill" else DECODE_TIMED_KV_LEN
        lens = [kv_len] * b
        q, k, v = flash_inputs(torch, case, torch.bfloat16, seed=99)
        (qh, kh, vh), mask = sdpa_inputs(torch, q, k, v, causal, lens)
        pl = fa.plan(b, tq, tkv, hq, hkv, d, q.dtype, lens)
        kernel = lambda: fa.attention(q, k, v, causal=causal, kv_len=kv_len)
        plain = lambda: fa.attention_plain(q, k, v, causal=causal,
                                           kv_len=kv_len)
        sdpa = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, enable_gqa=True)
        # The same function at these inputs without a mask tensor: causal
        # from the top left is the ends-aligned mask when Tq = Tkv = kv_len,
        # and a single query row over a full cache needs no mask.
        sdpa_fast = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=tq == tkv, enable_gqa=True)
        big = label == "prefill"
        reps = 20 if big else 100
        n = dict(
            ms=device_ms(torch, kernel, reps=reps, rounds=5),
            library_ms=device_ms(torch, sdpa, reps=reps, rounds=5),
            library_fast_ms=device_ms(torch, sdpa_fast, reps=reps, rounds=5),
            plain_ms=call_ms(torch, plain, reps=3 if big else 20, warmup=1),
            call_ms=call_ms(torch, kernel, reps=20 if big else 100),
            host_ms=host_ms(torch, kernel),
            body=pl.body, plan=list(pl),
            kernels_us=kernel_us(torch, kernel))
        flops, nbytes = flash_work(case, kv_len, 2)
        n["flops"], n["bytes"] = flops, nbytes
        n["ops_ms"] = flops / BF16_FLOPS_PER_S * 1e3
        n["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        n["bound_ms"] = max(n["ops_ms"], n["bytes_ms"])
        n["bound_by"] = "operations" if n["ops_ms"] >= n["bytes_ms"] else "bytes"
        n["shape"] = [b, tq, tkv, hq, hkv, d]
        print(f"flash_attention time {label} bf16 b={b} tq={tq} tkv={tkv} "
              f"hq={hq} hkv={hkv} d={d} kv_len={kv_len}: {pl} device "
              f"{n['ms'] * 1e3:.1f} us; by kernel "
              f"{ {k: round(x, 2) for k, x in n['kernels_us'].items()} } us; "
              f"{n['call_ms'] * 1e3:.1f} us per call from the host (host work "
              f"alone {n['host_ms'] * 1e3:.1f} us); plain "
              f"{n['plain_ms'] * 1e3:.1f} us; SDPA (explicit mask, enable_gqa) "
              f"{n['library_ms'] * 1e3:.1f} us, without the mask "
              f"{n['library_fast_ms'] * 1e3:.1f} us; bound "
              f"{n['bound_ms'] * 1e3:.3f} us by {n['bound_by']} ({flops} FLOP "
              f"at 989 TFLOP/s = {n['ops_ms'] * 1e3:.3f} us, {nbytes} bytes "
              f"at 3.35 TB/s = {n['bytes_ms'] * 1e3:.3f} us)", flush=True)
        if big:
            q32, k32, v32 = (x.float() for x in (q, k, v))
            n["f32_plan"] = list(fa.plan(b, tq, tkv, hq, hkv, d, q32.dtype,
                                         lens))
            n["f32_kernels_us"] = kernel_us(torch, lambda: fa.attention(
                q32, k32, v32, causal=causal, kv_len=kv_len), n=5)
            print(f"flash_attention time {label} f32: {n['f32_plan']} by "
                  f"kernel { {k: round(x, 1) for k, x in n['f32_kernels_us'].items()} }"
                  f" us", flush=True)
        out[label] = n
    return out


def serve_main_path(torch, np, fa):
    """``repro_torch.launch.serve.main`` at full width in bf16, once with
    two new tokens as a warm-up, then counted: the flash kernel must launch
    exactly 24 x 32 times: the prefill's 24 on the mma body, the decode
    steps' on the split body and its combine, none on simt. Returns (calls,
    the launches by body, prefill tok/s, decode tok/s)."""
    import contextlib
    import io
    import re

    from repro_torch.launch import serve

    warm = SERVE_ARGS[:-1] + ["2"]
    with contextlib.redirect_stdout(io.StringIO()):
        serve.main(warm)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    fa.reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        seq = serve.main(SERVE_ARGS)
    wall = time.perf_counter() - t
    launches = fa.launches["flash_attention"]
    bodies = {k: fa.launches[k] for k in SERVE_BODIES}
    text = buf.getvalue()
    print(text.rstrip(), flush=True)
    rates = [float(x.replace(",", "")) for x in
             re.findall(r"\(([\d,]+) tok/s\)", text)]
    print(f"serve {' '.join(SERVE_ARGS)}: wall {wall:.2f} s (weights drawn "
          f"on the card included), peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"flash_attention launches {launches} (want {SERVE_LAUNCHES}), by "
          f"body {bodies} (want {SERVE_BODIES})", flush=True)
    if launches != SERVE_LAUNCHES or bodies != SERVE_BODIES:
        raise AssertionError(f"serve launched flash_attention {launches} "
                             f"times, {bodies}, want {SERVE_LAUNCHES}, "
                             f"{SERVE_BODIES}")
    if seq.shape != (8, 32) or not ((seq >= 0) & (seq < 151936)).all():
        raise AssertionError(f"serve returned tokens {seq.shape} out of range")
    if len(rates) != 2:
        raise AssertionError(f"serve printed no rates: {text!r}")
    return launches, bodies, rates[0], rates[1]


def full_width_f32(torch):
    """qwen2-0.5b's full config in float32, with TF32 off for matrix
    products (stated: a reference in f32 must not round to TF32)."""
    from repro_torch.configs import get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return dataclasses.replace(get_config("qwen2-0.5b"), dtype="float32")


def teacher_forced(torch, model, cfg, tokens, prompt):
    """Logits of a prefill over ``tokens[:, :prompt]`` and of a decode step
    for each later token: [steps, B, V]."""
    from repro_torch.models import lm

    b, t = tokens.shape
    cache = lm.init_cache(cfg, b, t, device="cuda")
    logits, cache = lm.prefill(model, cfg, tokens=tokens[:, :prompt],
                               cache=cache)
    steps = [logits]
    for i in range(prompt, t):
        logits, cache = lm.decode_step(model, cfg, tokens[:, i], cache, i)
        steps.append(logits)
    return torch.stack(steps)


def consistency(torch, np, fa):
    """Full width, f32: prefill + teacher-forced decode through the kernel
    equal ``forward``'s logits, and the same steps with the plain attention
    on the card, at 3e-4."""
    from unittest import mock

    from repro_torch.models import lm

    cfg = full_width_f32(torch)
    model = lm.init(torch.Generator("cuda").manual_seed(0), cfg)
    b, p, n = CONSIST
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p + n))
                              .astype(np.int32)).cuda()
    h, _ = lm.forward(model, cfg, tokens=tokens)
    full = lm.logits_fn(model, cfg, h)[:, p - 1:].transpose(0, 1)  # [steps, B, V]
    fa.reset_launches()
    kern = teacher_forced(torch, model, cfg, tokens, p)
    used = dict(fa.launches)
    with mock.patch.object(fa, "attention", fa.attention_plain):
        plain = teacher_forced(torch, model, cfg, tokens, p)
    # f32: the prefill on the CUDA-core body, the decode steps split.
    want = {"flash_attention": 24 * (n + 1), "flash_attention_simt": 24,
            "flash_attention_split": 24 * n,
            "flash_attention_combine": 24 * n, "flash_attention_mma": 0}
    if fa.launches != used or used != want:
        raise AssertionError(f"kernel launches {used}, then {fa.launches}, "
                             f"want {want}")
    e_full = (kern - full).abs().max().item()
    e_plain = (kern - plain).abs().max().item()
    print(f"consistency qwen2-0.5b f32 full width, batch {b}, prompt {p}, "
          f"{n} decode steps ({used}): prefill+decode vs forward max abs "
          f"error "
          f"{e_full:.3e}, vs the plain attention on the card {e_plain:.3e} "
          f"(tol {CONSIST_TOL}; |logits| up to "
          f"{full[..., :cfg.vocab_size].abs().max().item():.3f})",
          flush=True)
    torch.testing.assert_close(kern, full, rtol=CONSIST_TOL, atol=CONSIST_TOL)
    torch.testing.assert_close(kern, plain, rtol=CONSIST_TOL, atol=CONSIST_TOL)
    return max(e_full, e_plain)


def against_golden(torch, np):
    """Full width, f32, the numpy recipe's weights: the top-32 logits of a
    prefill and 3 decode steps against the reference's golden (indices and
    values) and the logsumexp. An index may differ from the golden's only
    where the golden's own values at the two ranks lie within 2 x tol (a
    near-tie); the golden keeps 40 ranks for that."""
    from repro_torch.convert import lm_params_from_numpy, numpy_lm_params

    g = np.load(GOLDEN)
    cfg = full_width_f32(torch)
    t = time.perf_counter()
    model = lm_params_from_numpy(cfg, numpy_lm_params(cfg, int(g["seed"])),
                                 device="cuda")
    print(f"golden: numpy weights (seed {int(g['seed'])}) to the card in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    tokens = torch.from_numpy(g["tokens"]).cuda()
    lg = teacher_forced(torch, model, cfg, tokens, int(g["prompt_len"]))
    lg = lg.cpu().numpy()
    k = int(g["topk"])
    gold_idx, gold_val = g["top_idx"], g["top_val"]
    at = np.take_along_axis(lg, gold_idx[..., :k], -1)
    err = float(np.abs(at - gold_val[..., :k]).max())
    m = lg.max(-1)
    lse = m + np.log(np.exp(lg - m[..., None]).sum(-1))
    lse_err = float(np.abs(lse - g["lse"]).max())
    idx = np.argsort(-lg, -1, kind="stable")[..., :k]
    swaps = 0
    for pos in zip(*np.nonzero(idx != gold_idx[..., :k])):
        row_idx, row_val = gold_idx[pos[:-1]], gold_val[pos[:-1]]
        hit = np.nonzero(row_idx == idx[pos])[0]
        if not (len(hit) and abs(row_val[hit[0]] - row_val[pos[-1]])
                <= 2 * GOLDEN_TOL):
            raise AssertionError(f"golden: top-{k} index {idx[pos]} at rank "
                                 f"{pos} is no near-tie of the golden's")
        swaps += 1
    print(f"golden qwen2-0.5b f32 full width vs the reference (CPU, f32): "
          f"top-{k} values max abs error {err:.3e}, logsumexp {lse_err:.3e} "
          f"(tol {GOLDEN_TOL}), top-{k} indices equal but for {swaps} "
          f"near-tie swaps (the golden's smallest neighbour gap "
          f"{float(g['min_gap']):.3e})", flush=True)
    np.testing.assert_allclose(at, gold_val[..., :k], rtol=GOLDEN_TOL,
                               atol=GOLDEN_TOL)
    np.testing.assert_allclose(lse, g["lse"], rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
    return max(err, lse_err)


def against_golden_bf16(torch, np, fa):
    """Full width in bfloat16, the serve path's dtype: the numpy recipe's
    weights rounded to bf16, a prefill of 8 tokens (56 rows a kv head:
    the ``mma`` body) and three decode steps (``split`` + ``combine``)
    against the reference's bf16 golden (``GOLDEN_BF16``). Per row, the
    card's logits at the golden's top-32 indices, its own top-32 values in
    order, and its logsumexp, each within GOLDEN_BF16_TOL x (|golden| + the
    row's RMS over the vocabulary) (the logsumexp, a softmax-weighted mean
    of the logits, within the tolerance x the RMS). Returns the largest
    such scaled error."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy, numpy_lm_params

    g = np.load(GOLDEN_BF16)
    cfg = get_config("qwen2-0.5b")
    if cfg.dtype != str(g["dtype"]):
        raise AssertionError(f"config dtype {cfg.dtype}, golden {g['dtype']}")
    model = lm_params_from_numpy(cfg, numpy_lm_params(cfg, int(g["seed"])),
                                 device="cuda")
    tokens = torch.from_numpy(g["tokens"]).cuda()
    fa.reset_launches()
    lg = teacher_forced(torch, model, cfg, tokens, int(g["prompt_len"]))
    used = dict(fa.launches)
    lg = lg.float().cpu().numpy()                            # [steps, B, V]
    steps = lg.shape[0] - 1
    want = {"flash_attention": 24 * (steps + 1), "flash_attention_mma": 24,
            "flash_attention_split": 24 * steps,
            "flash_attention_combine": 24 * steps, "flash_attention_simt": 0}
    if used != want:
        raise AssertionError(f"kernel launches {used}, want {want}")
    k = int(g["topk"])
    gold_idx, gold_val = g["top_idx"][..., :k], g["top_val"][..., :k]
    rms = g["rms"][..., None]
    scale = np.abs(gold_val) + rms
    at = np.take_along_axis(lg, gold_idx, -1)
    mine = -np.sort(-lg, -1)[..., :k]
    m = lg.max(-1)
    lse = m + np.log(np.exp(lg - m[..., None]).sum(-1))
    errs = {"at the golden's top-32": float((np.abs(at - gold_val) / scale).max()),
            "own top-32 values": float((np.abs(mine - gold_val) / scale).max()),
            "logsumexp": float((np.abs(lse - g["lse"]) / g["rms"]).max())}
    same = int((np.argsort(-lg, -1, kind="stable")[..., :k] == gold_idx).sum())
    print(f"golden qwen2-0.5b bf16 full width vs the reference (CPU, bf16), "
          f"prefill on the mma body, {steps} decode steps on split: scaled "
          f"errors { {n: round(e, 5) for n, e in errs.items()} } (tol "
          f"{GOLDEN_BF16_TOL} x (|golden| + row RMS)); max abs error at the "
          f"golden's top-{k} {float(np.abs(at - gold_val).max()):.3e} (row "
          f"RMS {float(g['rms'].min()):.3f}-{float(g['rms'].max()):.3f}); "
          f"{same} of {gold_idx.size} top-{k} ranks hold the golden's index",
          flush=True)
    worst = max(errs.values())
    if not worst <= GOLDEN_BF16_TOL:
        raise AssertionError(f"bf16 logits off the reference's golden: "
                             f"{errs}, tol {GOLDEN_BF16_TOL}")
    return worst


def serve_profiles(torch):
    """``torch.profiler`` over one prefill of the serve main path's shape
    (qwen2-0.5b, bf16, batch 8 x 2048) and over 8 decode steps after it:
    device busy share and top kernels."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    cfg = get_config("qwen2-0.5b")
    g = torch.Generator("cuda").manual_seed(0)
    model = lm.init(g, cfg)
    b, p, n = 8, 2048, 8
    tokens = torch.randint(0, cfg.vocab_size, (b, p), generator=g,
                           device="cuda", dtype=torch.int32)
    cache = lm.init_cache(cfg, b, p + n, device="cuda")
    cur = tokens[:, -1].contiguous()

    def decode():
        for i in range(n):
            lm.decode_step(model, cfg, cur, cache, p + i)

    profile_run(torch, lambda: lm.prefill(model, cfg, tokens=tokens,
                                          cache=cache),
                1, f"serve qwen2-0.5b bf16 prefill batch {b} x {p}", "prefill")
    profile_run(torch, decode, n, f"serve qwen2-0.5b bf16 decode batch {b} "
                f"at cache length {p}", "step")


def lm_phases(torch, np):
    """The LM serving path: the flash kernel against its plain version, its
    times, serve at full width (counted), consistency, the golden and the
    profiles. Returns the ``flash_attention`` entry of the kernels line."""
    from repro_torch.kernels import flash_attention as fa

    err, err_by_body = phase("flash_attention check", check_flash, torch, fa)
    ex2_abs, ex2_rel = phase("flash_attention ex2 error", ex2_error, torch, fa)
    timed = phase("flash_attention time", flash_times, torch, fa)
    launches, bodies, prefill_tps, decode_tps = phase(
        "serve main path", serve_main_path, torch, np, fa)
    phase("serve consistency", consistency, torch, np, fa)
    phase("serve against the golden", against_golden, torch, np)
    bf16_err = phase("serve against the bf16 golden", against_golden_bf16,
                     torch, np, fa)
    phase("serve profiles", serve_profiles, torch)
    pre, dec = timed["prefill"], timed["decode"]
    us = {**pre["kernels_us"], **dec["kernels_us"]}
    return dict(
        name="flash_attention", route="cuda", source=FLASH_SOURCE,
        replaces=FLASH_REPLACES, launches=launches, max_abs_err=err,
        ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
        bound_by=pre["bound_by"], library_ms=pre["library_ms"],
        call_ms=pre["call_ms"], host_ms=pre["host_ms"], shape=pre["shape"],
        dtype="bfloat16",
        decode=dict((k, dec[k]) for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_fast_ms", "call_ms", "host_ms", "shape", "plan")),
        library_fast_ms=pre["library_fast_ms"], plan=pre["plan"],
        ex2_max_abs_err=ex2_abs, ex2_max_rel_err=ex2_rel,
        bodies={
            "mma": dict(launches=bodies["flash_attention_mma"],
                        ms=us.get("mma_kernel", 0.0) / 1e3, at="prefill",
                        max_abs_err=err_by_body.get("mma_bfloat16")),
            "split": dict(launches=bodies["flash_attention_split"],
                          ms=us.get("split_kernel", 0.0) / 1e3, at="decode",
                          max_abs_err=max(err_by_body.get("split_bfloat16", 0),
                                          err_by_body.get("split_float32", 0))),
            "combine": dict(launches=bodies["flash_attention_combine"],
                            ms=us.get("combine_kernel", 0.0) / 1e3,
                            at="decode"),
            "simt": dict(launches=bodies["flash_attention_simt"],
                         ms=pre["f32_kernels_us"].get("simt_kernel", 0.0) / 1e3,
                         at="prefill (f32)",
                         max_abs_err=err_by_body.get("simt_float32"))},
        serve_prefill_tok_s=prefill_tps, serve_decode_tok_s=decode_tps,
        golden_bf16_scaled_err=bf16_err, golden_bf16_tol=GOLDEN_BF16_TOL)


# ---------------------------------------------------------------------------
# Placement (phase 10b): the anneal kernel, the BENCH placement and
# multilevel rows.
# ---------------------------------------------------------------------------

ANNEAL_SOURCE = "src/repro_torch/kernels/csrc/anneal.cu"
#: Not a TPU kernel: the reference's search is one XLA scan.
ANNEAL_REPLACES = "src/repro/place/anneal.py:234 (_anneal_jit, an XLA scan)"
PLACEMENT_GOLDEN = ROOT / "tests" / "fixtures" / "placement_golden.npz"
#: The BENCH ``placement`` rows: name -> (arrow_lu_graph args, grid,
#: AnnealConfig keywords, cycles of identity / random / annealed /
#: annealed_identity, anneal costs (random init, annealed)).
PLACEMENT_ROWS = {
    "n3689": ((2, 8, 6, 3), (8, 8),
              dict(replicas=8, rounds=32, steps=1024, seed=0),
              {"identity": 806, "random": 1021, "annealed": 684,
               "annealed_identity": 634}, (1_104_696, 1_045_048)),
    "n10308": ((4, 8, 8, 3), (16, 16),
               dict(replicas=8, rounds=64, steps=2048, seed=0),
               {"identity": 1663, "random": 2139, "annealed": 1448,
                "annealed_identity": 1314}, (2_640_638, 2_302_114)),
}
#: The BENCH multilevel row (``surrogate_multilevel_n117972``): the main
#: path's n117972 graph on 16x16, benchmarks/placement_bench.py's
#: MULTILEVEL_COARSE / MULTILEVEL_REFINE at ratio 32, under the megakernel.
MULTILEVEL_ROW = "n117972"
MULTILEVEL = dict(coarse=dict(replicas=8, rounds=24, steps=2048, seed=0),
                  refine=dict(replicas=4, rounds=8, steps=2048, seed=0),
                  ratio=32, clusters=5645,
                  costs=(225_687_381, 225_669_734),
                  cycles={"round_robin": 14213, "multilevel": 8966})
#: The BENCH ``fig1_full`` row (``--fig1-full`` only): n502447 on 16x16,
#: FIG1_FULL_COARSE / FIG1_FULL_REFINE at ratio 32, under the megakernel.
FIG1_FULL = dict(coarse=dict(replicas=8, rounds=24, steps=2048, seed=0),
                 refine=dict(replicas=4, rounds=6, steps=2048, seed=0),
                 ratio=32, nodes=502447, clusters=19711,
                 costs=(3_961_010_560, 3_960_992_728),
                 cycles={"round_robin": 56624, "multilevel": 47043})
#: The anneal kernel against its plain version: (arrow_lu_graph args,
#: grid) x replicas x rounds (two rounds: both exchange parities) x seeds,
#: 24 steps a round; 40 replicas share warps.
ANNEAL_GRAPHS = (((2, 4, 3), (2, 2)), ((2, 4, 3), (4, 4)),
                 ((2, 8, 6), (8, 8)), ((4, 8, 8), (16, 16)))
ANNEAL_REPLICAS = (1, 2, 8, 40)
ANNEAL_ROUNDS = (1, 2)
ANNEAL_SEEDS = (0, 7)
#: The timed search: n3689's BENCH ladder over 2 rounds of 64 steps, the
#: kernel and its plain version on the same inputs.
ANNEAL_TIMED = ("n3689", dict(replicas=8, rounds=2, steps=64, seed=0))
#: 32-bit integer operations a proposal's Threefry blocks take at least:
#: twelve blocks of 20 rounds (add, rotate, xor) and five key injections.
THREEFRY_OPS = 12 * (20 * 3 + 5 * 3)
#: The float32 rate outside the tensor cores, the table's nearest to the
#: integer units (an upper bound on their rate, so the bound stays a bound).
SCALAR_OPS_PER_S = 67e12


def fig1_full_setup():
    """The ``fig1_full`` graph (built, or loaded from the graph cache) and its
    ``reference_evaluate`` values, and the seconds they took. Runs in a
    worker process while the card works."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import workloads as wl
    from repro_torch.core.graph import reference_evaluate

    t = time.perf_counter()
    g = wl.fig1_full()
    return g, reference_evaluate(g), time.perf_counter() - t


def anneal_case(torch, np, pa, args, grid, acfgs):
    """One search of ``acfgs`` (one ladder each) on the card and by the
    plain version on the card; every rung's best placement, best cost and
    the init cost must be equal as integers. Returns the results."""
    from repro_torch.core import prng
    from repro_torch.core import workloads as wl
    from repro_torch.place.cost import edge_tables

    g = wl.arrow_lu_graph(*args, seed=3)
    src, dst, w_edge, w_node = edge_tables(g)
    nbr, w_inc, is_out = pa.incidence_from_edges(src, dst, w_edge,
                                                 g.num_nodes)
    inits = [pa._check_init(None, g.num_nodes, grid[0] * grid[1], a.seed)
             for a in acfgs]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    tensors = (t(np.stack(inits)), t(nbr), t(w_inc), t(is_out), t(w_node),
               t(np.stack([pa._thresholds(a) for a in acfgs])),
               torch.stack([prng.key(a.seed) for a in acfgs]).cuda())
    knobs = dict(nx=grid[0], ny=grid[1], rounds=acfgs[0].rounds,
                 steps=acfgs[0].steps,
                 pressure_weight=acfgs[0].pressure_weight)
    from repro_torch.kernels import anneal as ka

    got = ka.anneal_ladders(*tensors, **knobs)
    want = ka.anneal_plain(*tensors, **knobs)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, want))
    if err != 0:
        raise AssertionError(f"anneal kernel differs from its plain version "
                             f"on arrow_lu_graph{args} {grid}, "
                             f"{[dataclasses.astuple(a) for a in acfgs]}: "
                             f"max abs error {err}")
    return got


def check_anneal(torch, np):
    """The anneal kernel against its plain version (both on the card):
    small budgets over several graphs, grids, replica counts (1, 2, 8, 40),
    one or two rounds (both exchange parities) and seeds, and a batch of
    three ladders (``anneal_tables_many``'s launch). Returns (max abs
    error, cases)."""
    from repro_torch.place import anneal as pa
    from repro_torch.place.spec import AnnealConfig

    cases = 0
    for args, grid in ANNEAL_GRAPHS:
        for R in ANNEAL_REPLICAS:
            for rounds in ANNEAL_ROUNDS:
                for seed in ANNEAL_SEEDS:
                    anneal_case(torch, np, pa, args, grid, [AnnealConfig(
                        replicas=R, rounds=rounds, steps=24, seed=seed,
                        t_max=200.0)])
                    cases += 1
        anneal_case(torch, np, pa, args, grid, [
            AnnealConfig(replicas=8, rounds=3, steps=24, seed=s, t_max=t)
            for s, t in ((0, 64.0), (1, 4.0), (2, 500.0))])
        cases += 1
    print(f"anneal kernel equals its plain version in {cases} cases",
          flush=True)
    return 0, cases


def placement_rows(torch, np, graphs, ka, lod, mk, fig1_job):
    """The slice's main path: the BENCH ``placement`` rows (each search on
    the card, then identity / random / annealed / annealed_identity through
    ``evaluate_placements`` under ``select`` and ``megakernel``) and the
    multilevel row n117972 (coarsen, both anneals on the card, round-robin
    and multilevel under ``megakernel``), and ``fig1_full`` the same way
    where ``fig1_job`` (the future of :func:`fig1_full_setup`) is given.
    Every cycle count and cost must equal the BENCH value, every searched
    placement the reference's (the fixture), the engines' results
    bit-identical. The launch counts are set to 0 just before and read just
    after. Returns (counts, walls {row: anneal seconds})."""
    from repro_torch import place
    from repro_torch.core import workloads as wl
    from repro_torch.core.graph import reference_evaluate
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.place.spec import AnnealConfig, PlacementSpec

    z = np.load(PLACEMENT_GOLDEN)
    rows = {name: wl.arrow_lu_graph(*args[:3], seed=args[3])
            for name, (args, *_) in PLACEMENT_ROWS.items()}
    refs = {name: reference_evaluate(g) for name, g in rows.items()}
    g_ml, ref_ml = graphs.graph(MULTILEVEL_ROW)
    fig1 = None
    if fig1_job is not None:
        t = time.perf_counter()
        fig1, ref_fig1, took = fig1_job.result()
        print(f"set-up fig1_full: {fig1.num_nodes} nodes and reference "
              f"values in {took:.1f} s (a worker; waited "
              f"{time.perf_counter() - t:.1f} s)", flush=True)
    for k in (ka, lod, mk):
        k.reset_launches()
    walls = {}
    for name, (args, (nx, ny), kw, cycles, costs) in PLACEMENT_ROWS.items():
        g, acfg = rows[name], AnnealConfig(**kw)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ann = place.anneal_placement(g, nx, ny, acfg)
        walls[name] = time.perf_counter() - t
        ann_id = place.anneal_placement(
            g, nx, ny, acfg, init=place.resolve(g, nx, ny, "round_robin"))
        print(f"placement {name}: anneal costs {ann.init_cost} -> "
              f"{ann.cost} (BENCH {costs[0]} -> {costs[1]}), identity init "
              f"{ann_id.init_cost} -> {ann_id.cost}, search wall "
              f"{walls[name]:.3f} s", flush=True)
        if (ann.init_cost, ann.cost) != costs:
            raise AssertionError(f"placement {name}: costs {ann.init_cost} "
                                 f"-> {ann.cost}, BENCH {costs}")
        for tag, r in (("annealed", ann), ("annealed_identity", ann_id)):
            if not (np.array_equal(r.node_pe, z[f"{name}/{tag}/node_pe"])
                    and np.array_equal(r.replica_costs,
                                       z[f"{name}/{tag}/replica_costs"])):
                raise AssertionError(f"placement {name} {tag}: the search "
                                     f"differs from the reference's")
        got = {}
        for engine in ("select", "megakernel"):
            t = time.perf_counter()
            res = place.evaluate_placements(g, nx, ny, {
                "identity": None,
                "random": PlacementSpec(strategy="random", seed=acfg.seed),
                "annealed": ann.node_pe,
                "annealed_identity": ann_id.node_pe,
            }, cfgs=OverlayConfig(scheduler="ooo", max_cycles=4_000_000,
                                  engine=engine))
            seen = {k: r.cycles for k, r in res.items()}
            print(f"placement {name} {engine}: cycles {seen} (BENCH "
                  f"{cycles}), wall {time.perf_counter() - t:.2f} s",
                  flush=True)
            if seen != cycles or not all(
                    r.done and np.allclose(r.values, refs[name], rtol=1e-5,
                                           atol=1e-5)
                    for r in res.values()):
                raise AssertionError(f"placement {name} {engine}: {seen}, "
                                     f"values against reference_evaluate")
            got[engine] = res
        for k in cycles:
            if not same_result(np, got["select"][k], got["megakernel"][k]):
                raise AssertionError(f"placement {name} {k}: the engines "
                                     f"differ")
    runs = [(MULTILEVEL_ROW, g_ml, ref_ml, MULTILEVEL,
             z["multilevel/node_pe"])]
    if fig1 is not None:
        runs.append(("fig1_full", fig1, ref_fig1, FIG1_FULL, None))
    for name, g, ref, spec, want_pe in runs:
        torch.cuda.synchronize()
        t = time.perf_counter()
        ml = place.multilevel_anneal(
            g, 16, 16, AnnealConfig(**spec["coarse"]), ratio=spec["ratio"],
            refine=AnnealConfig(**spec["refine"]))
        walls[name] = time.perf_counter() - t
        t = time.perf_counter()
        res = place.evaluate_placements(g, 16, 16, {
            "round_robin": "round_robin", "multilevel": ml.node_pe},
            cfgs=OverlayConfig(scheduler="ooo", max_cycles=16_000_000,
                               engine="megakernel"))
        seen = {k: r.cycles for k, r in res.items()}
        ok_vals = all(bool(np.allclose(r.values, ref, rtol=1e-5, atol=1e-5))
                      for r in res.values())
        print(f"placement multilevel {name} (n{g.num_nodes}): "
              f"{ml.num_clusters} clusters, costs {ml.projected_cost} -> "
              f"{ml.cost} (BENCH {spec['costs']}), cycles {seen} (BENCH "
              f"{spec['cycles']}), search wall {walls[name]:.2f} s, "
              f"simulation wall {time.perf_counter() - t:.2f} s, values "
              f"match {ok_vals}", flush=True)
        if (ml.num_clusters != spec["clusters"]
                or (ml.projected_cost, ml.cost) != spec["costs"]
                or seen != spec["cycles"] or not ok_vals
                or (want_pe is not None
                    and not np.array_equal(ml.node_pe, want_pe))):
            raise AssertionError(f"placement multilevel {name} differs from "
                                 f"the BENCH row")
    counts = dict(ka.launches, **lod.launches, **mk.launches)
    print(f"placement kernel launches: {counts}", flush=True)
    for k in ("anneal", "schedule_step", "mega_chunk_batched"):
        if counts[k] == 0:
            raise AssertionError(f"the placement path never launched {k}")
    return counts, walls


def anneal_times(torch, np, ka):
    """The anneal kernel's device time on the timed search beside its plain
    version's on the same inputs (CUDA events, synchronised), and each
    BENCH row's full search: device ms, us per step (the replicas' steps
    run side by side) and per proposal. Returns the kernels-line fields."""
    from repro_torch.core import prng
    from repro_torch.core import workloads as wl
    from repro_torch.place import anneal as pa
    from repro_torch.place.cost import edge_tables
    from repro_torch.place.spec import AnnealConfig

    def inputs(name, acfg):
        args, (nx, ny), *_ = PLACEMENT_ROWS[name]
        g = wl.arrow_lu_graph(*args[:3], seed=args[3])
        src, dst, w_edge, w_node = edge_tables(g)
        tabs = pa.incidence_from_edges(src, dst, w_edge, g.num_nodes)
        init = pa._check_init(None, g.num_nodes, nx * ny, acfg.seed)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
        tensors = (t(init[None]), *map(t, tabs), t(w_node),
                   t(pa._thresholds(acfg)[None]),
                   prng.key(acfg.seed)[None].cuda())
        knobs = dict(nx=nx, ny=ny, rounds=acfg.rounds, steps=acfg.steps,
                     pressure_weight=acfg.pressure_weight)
        return g, tabs, tensors, knobs

    def timed(fn, reps):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out)

    name, kw = ANNEAL_TIMED
    acfg = AnnealConfig(**kw)
    g, (nbr, w_inc, is_out), tensors, knobs = inputs(name, acfg)
    search = lambda: ka.anneal_ladders(*tensors, **knobs)
    # the kernel's own device time (profiler), and the search's (events:
    # the ladder's start, the keys' copy and the kernel)
    ms = kernel_us(torch, search, 5, ("anneal_kernel",))["anneal_kernel"] / 1e3
    call_ms = timed(search, 5)
    plain_ms = timed(lambda: ka.anneal_plain(*tensors, **knobs), 1)
    want = ka.anneal_plain(*tensors, **knobs)
    if any(not torch.equal(a, b) for a, b in zip(search(), want)):
        raise AssertionError("the timed search differs from its plain version")
    steps = acfg.rounds * acfg.steps
    proposals = steps * acfg.replicas
    # bytes: each input read once (init, the incidence tables, weights,
    # thresholds, keys), each output written once (every rung's best
    # placement and cost, the init cost)
    n, R = g.num_nodes, acfg.replicas
    nbytes = (4 * n + nbr.nbytes + w_inc.nbytes + is_out.nbytes + 4 * n
              + 8 * R + 16 + 4 * R * n + 8 * R + 8)
    ops = proposals * THREEFRY_OPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    out = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               shape=dict(row=name, n=n, grid=list(knobs.values())[:2],
                          **kw), us_per_step=ms * 1e3 / steps,
               us_per_proposal=ms * 1e3 / proposals,
               plain_us_per_step=plain_ms * 1e3 / steps)
    print(f"anneal time {name} R={R} {acfg.rounds}x{acfg.steps}: kernel "
          f"{ms:.3f} ms ({out['us_per_step']:.3f} us a step, "
          f"{out['us_per_proposal']:.3f} us a proposal), search {call_ms:.3f} "
          f"ms, plain "
          f"{plain_ms:.1f} ms ({out['plain_us_per_step']:.1f} us a step), "
          f"bound {out['bound_ms'] * 1e3:.3f} us ({out['bound_by']}: bytes "
          f"{bytes_ms * 1e3:.3f} us, operations {ops_ms * 1e3:.3f} us)",
          flush=True)
    rows = {}
    for row, (_, _, kw_row, _, _) in PLACEMENT_ROWS.items():
        acfg = AnnealConfig(**kw_row)
        _, (nbr, *_), tensors, knobs = inputs(row, acfg)
        row_ms = kernel_us(torch, lambda: ka.anneal_ladders(
            *tensors, **knobs), 2, ("anneal_kernel",))["anneal_kernel"] / 1e3
        steps = acfg.rounds * acfg.steps
        rows[row] = dict(ms=row_ms, steps=steps,
                         us_per_step=row_ms * 1e3 / steps,
                         us_per_proposal=row_ms * 1e3 / steps / acfg.replicas,
                         degree=int(nbr.shape[1]))
        print(f"anneal time {row} (BENCH budget, R={acfg.replicas} "
              f"{acfg.rounds}x{acfg.steps}): {row_ms:.2f} ms, "
              f"{rows[row]['us_per_step']:.3f} us a step, "
              f"{rows[row]['us_per_proposal']:.3f} us a proposal, "
              f"incidence row width {nbr.shape[1]}", flush=True)
    out["rows"] = rows
    return out


# ---------------------------------------------------------------------------
# The surrogate (phase 10c): the guided anneal kernel, the BENCH surrogate
# and guided rows, the smoke CLI.
# ---------------------------------------------------------------------------

#: Not a TPU kernel: the reference's guided search is one XLA scan.
GUIDED_REPLACES = ("src/repro/place/anneal.py:297 (_anneal_guided_jit, an "
                   "XLA scan)")
SURROGATE_GOLDEN = ROOT / "tests" / "fixtures" / "surrogate_golden.npz"
#: The BENCH ``surrogate`` rank rows and ``guided`` rows, by placement row
#: (graph, grid and the unguided budget from PLACEMENT_ROWS): training-set
#: cycles min/max, held-out Spearman (four digits), pruned = exhaustive
#: best, the guided search's cost, cost evaluations and proposals (rounds
#: x 2, margin 0.0) and its simulated cycles.
SURROGATE_ROWS = {
    "n3689": dict(train=(800, 3087), spearman=0.9611, best=807,
                  cost=1_043_717, evals=73_481, proposals=524_288,
                  cycles=652),
    "n10308": dict(train=(1663, 5319), spearman=0.9424, best=1652,
                   cost=2_282_179, evals=217_408, proposals=2_097_152,
                   cycles=1372),
}
SURROGATE_TRAIN, SURROGATE_HELD, SURROGATE_KEEP = 48, 64, 8
#: The reference's beta against the port's: the solves differ in their last
#: bits (fault 5); gamma_q must be equal.
BETA_RTOL = 1e-10
#: The guided kernel against its plain version: (arrow_lu_graph args, grid)
#: x replicas x guide_every, the margins and round counts cycling through
#: the cases, 24 steps a round; a coarse guide and a batch of three ladders
#: per graph. The 8x8 and 16x16 graphs take the fixture's fitted slopes,
#: the others slopes drawn from a seed.
GUIDED_GRAPHS = ((((2, 4, 3), (2, 2)), None), (((2, 4, 3), (4, 2)), None),
                 (((2, 8, 6), (8, 8)), "n3689"),
                 (((4, 8, 8), (16, 16)), "n10308"))
GUIDED_REPLICAS = (1, 2, 8)
GUIDED_EVERY = (1, 3)
GUIDED_MARGINS = (0.0, float("inf"), -2.5)
#: The timed guided search: n3689's ladder over 2 rounds of 64 steps (as
#: ANNEAL_TIMED), the kernel and its plain version on the same inputs.
GUIDED_TIMED = ("n3689", dict(replicas=8, rounds=2, steps=64, seed=0))


def guide_for(np, golden, extractor, name, seed):
    """A Guide over ``extractor``: the fixture's fitted slopes for a BENCH
    row, else slopes drawn from ``seed``."""
    from repro_torch.surrogate import delta as sd

    if name is not None:
        return sd.Guide(extractor=extractor, gamma_q=golden[f"{name}/gamma_q"])
    rng = np.random.default_rng(seed)
    return sd.Guide(extractor=extractor, gamma_q=rng.integers(
        -(1 << 20), 1 << 20, extractor.num_features).astype(np.int64))


def guided_case(torch, np, pa, ka, n, grid, tables, acfgs, guide, margin,
                every):
    """One guided search of ``acfgs`` (one ladder each) on the card by the
    kernel and by the plain version; every rung's best placement, best
    cost, the init cost and every rung's evals must be equal as integers.
    At an open gate (+inf) the kernel must also equal the unguided kernel.
    Returns the kernel's results."""
    from repro_torch.core import prng
    from repro_torch.surrogate import delta as sd

    src, dst, w_edge, w_node = tables
    nbr, w_inc, is_out = pa.incidence_from_edges(src, dst, w_edge, n)
    inits = [pa._check_init(None, n, grid[0] * grid[1], a.seed)
             for a in acfgs]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    tensors = (t(np.stack(inits)), t(nbr), t(w_inc), t(is_out),
               t(np.asarray(w_node, np.int32)),
               t(np.stack([pa._thresholds(a) for a in acfgs])),
               torch.stack([prng.key(a.seed) for a in acfgs]).cuda())
    knobs = dict(nx=grid[0], ny=grid[1], rounds=acfgs[0].rounds,
                 steps=acfgs[0].steps,
                 pressure_weight=acfgs[0].pressure_weight)
    ga = sd.guide_arrays(guide)
    q = sd.quantize_margin(margin)
    got = ka.anneal_ladders(*tensors, **knobs, guide=ga, q_margin=q,
                            guide_every=every)
    want = ka.anneal_guided_plain(*tensors, sd.to_device(ga, "cuda"), q,
                                  guide_every=every, **knobs)
    torch.cuda.synchronize()
    label = (f"{n} items on {grid}, "
             f"{[dataclasses.astuple(a) for a in acfgs]}, margin {margin}, "
             f"every {every}")
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, want))
    if err != 0:
        raise AssertionError(f"guided anneal kernel differs from its plain "
                             f"version ({label}): max abs error {err}")
    if margin == float("inf"):
        plain = ka.anneal_ladders(*tensors, **knobs)
        if any(not torch.equal(a, b) for a, b in zip(got[:3], plain)):
            raise AssertionError(f"the open gate differs from the unguided "
                                 f"kernel ({label})")
        if not bool((got[3] == knobs["rounds"] * knobs["steps"]).all()):
            raise AssertionError(f"the open gate's evals ({label})")
    return got


def check_guided(torch, np):
    """The guided anneal kernel against its plain version (both on the
    card): four graphs and grids (2x2, 4x2, 8x8, 16x16), 1, 2 and 8
    replicas, guide_every 1 and 3, margins 0, +inf and -2.5, one and two
    rounds (both exchange parities); per graph a coarse guide
    (``Guide.coarsen``) on the quotient graph and a batch of three ladders.
    Returns (max abs error, cases)."""
    from repro_torch import surrogate
    from repro_torch.core import workloads as wl
    from repro_torch.kernels import anneal as ka
    from repro_torch.place import anneal as pa
    from repro_torch.place import coarsen
    from repro_torch.place.cost import edge_tables
    from repro_torch.place.spec import AnnealConfig

    z = np.load(SURROGATE_GOLDEN)
    cases = 0
    for gi, ((args, grid), name) in enumerate(GUIDED_GRAPHS):
        g = wl.arrow_lu_graph(*args, seed=3)
        guide = guide_for(np, z, surrogate.build_features(g, *grid), name, gi)
        tables = edge_tables(g)
        for R in GUIDED_REPLICAS:
            for every in GUIDED_EVERY:
                margin = GUIDED_MARGINS[cases % len(GUIDED_MARGINS)]
                rounds = 1 + cases % 2
                guided_case(torch, np, pa, ka, g.num_nodes, grid, tables,
                            [AnnealConfig(replicas=R, rounds=rounds,
                                          steps=24, seed=gi, t_max=200.0)],
                            guide, margin, every)
                cases += 1
        clusters = coarsen.cluster_nodes(g, 8)
        ctables = coarsen.quotient_tables(g, clusters)
        guided_case(torch, np, pa, ka, int(ctables[3].shape[0]), grid,
                    ctables, [AnnealConfig(replicas=8, rounds=2, steps=24,
                                           seed=1)],
                    guide.coarsen(clusters), 0.0, 1)
        guided_case(torch, np, pa, ka, g.num_nodes, grid, tables, [
            AnnealConfig(replicas=8, rounds=3, steps=24, seed=s, t_max=t)
            for s, t in ((0, 64.0), (1, 4.0), (2, 500.0))], guide, 0.0, 3)
        cases += 2
    print(f"guided anneal kernel equals its plain version in {cases} cases",
          flush=True)
    return 0, cases


def beta_margin(np, beta, sigma):
    """The smallest distance of ``gamma * 2**16`` from a half integer (a
    rounding boundary of gamma_q), over the features."""
    from repro_torch.surrogate.delta import GUIDE_SCALE

    gam = np.asarray(beta) / np.asarray(sigma) * GUIDE_SCALE
    return float(np.min(np.abs(gam - np.floor(gam) - 0.5)))


def surrogate_rows(torch, np, ka, mk):
    """The slice's main path: the BENCH ``surrogate`` rank rows and
    ``guided`` rows under the megakernel engine, counted (the launch counts
    set to 0 just before, read just after). Per row: ``fit_from_sim`` (48
    placements, seed 0) equal to the fixture's placements and cycles, the
    fit's mu and sigma bit-equal, beta within BETA_RTOL and gamma_q equal;
    the 64 held-out placements (seed 101) equal, their cycles the fixture's,
    Spearman and pruned = exhaustive best the BENCH values;
    ``evaluate_placements(prune="surrogate", keep_top=8)`` simulating
    exactly the 8 ranked names; the guided search (rounds x 2, margin 0.0)
    equal to the fixture's placement, cost, cost_evals and proposals, and
    its placement's simulated cycles the BENCH value, against the unguided
    placement's (phase 10b's, PLACEMENT_ROWS). Every placed memory must
    take the megakernel's ``shared`` body. Returns (counts, {row: walls})."""
    from repro_torch import place, surrogate
    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.place.spec import AnnealConfig
    from repro_torch.surrogate import delta as sd

    z = np.load(SURROGATE_GOLDEN)
    cfg = OverlayConfig(scheduler="ooo", max_cycles=4_000_000,
                        engine="megakernel")
    graphs = {name: wl.arrow_lu_graph(*args[:3], seed=args[3])
              for name, (args, *_) in PLACEMENT_ROWS.items()}
    for k in (ka, mk):
        k.reset_launches()
    walls = {}
    for name, want in SURROGATE_ROWS.items():
        args, (nx, ny), kw, cycles, _ = PLACEMENT_ROWS[name]
        g, w = graphs[name], {}
        key = lambda k: z[f"{name}/{k}"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, train, train_cycles = surrogate.fit_from_sim(
            g, nx, ny, cfg=cfg, n_train=SURROGATE_TRAIN, seed=0)
        w["fit"] = time.perf_counter() - t
        gamma_q = sd.build_guide(model).gamma_q
        beta_rel = float(np.max(np.abs(model.beta - key("beta"))
                                / np.abs(key("beta"))))
        margin = beta_margin(np, model.beta, model.sigma)
        print(f"surrogate {name}: fit on {SURROGATE_TRAIN} in {w['fit']:.2f} "
              f"s, training cycles {train_cycles.min()}..{train_cycles.max()} "
              f"(BENCH {want['train']}), beta max relative error "
              f"{beta_rel:.3e} (tolerance {BETA_RTOL}), gamma_q equal "
              f"{np.array_equal(gamma_q, key('gamma_q'))}, gamma * 2^16 "
              f"{margin:.6f} from a rounding boundary", flush=True)
        if not (np.array_equal(train, key("train/node_pe"))
                and np.array_equal(train_cycles, key("train/cycles"))
                and (train_cycles.min(), train_cycles.max()) == want["train"]
                and np.array_equal(model.mu, key("mu"))
                and np.array_equal(model.sigma, key("sigma"))
                and beta_rel <= BETA_RTOL
                and np.array_equal(gamma_q, key("gamma_q"))):
            raise AssertionError(f"surrogate {name}: the fit differs from "
                                 f"the reference's")
        t = time.perf_counter()
        held = surrogate.sample_placements(
            g, nx, ny, SURROGATE_HELD, seed=101, include_static=False)
        res = place.simulate_placements(g, nx, ny, list(held), cfg)
        held_cycles = np.asarray([r.cycles for r in res])
        w["held"] = time.perf_counter() - t
        rho = surrogate.spearman(model.predict_batch(held), held_cycles)
        keep = model.rank(held)[:SURROGATE_KEEP]
        best = (int(held_cycles[keep].min()), int(held_cycles.min()))
        print(f"surrogate {name}: {SURROGATE_HELD} held-out simulated in "
              f"{w['held']:.2f} s, Spearman {rho:.4f} (BENCH "
              f"{want['spearman']}), pruned best {best[0]}, exhaustive "
              f"{best[1]} (BENCH {want['best']})", flush=True)
        if not (np.array_equal(held, key("held/node_pe"))
                and all(r.done for r in res)
                and np.array_equal(held_cycles, key("held/cycles"))
                and round(rho, 4) == want["spearman"]
                and best == (want["best"], want["best"])):
            raise AssertionError(f"surrogate {name}: the held-out rows "
                                 f"differ from BENCH")
        t = time.perf_counter()
        names = {f"cand{i}": p for i, p in enumerate(held)}
        pruned = place.evaluate_placements(
            g, nx, ny, names, cfgs=cfg, prune="surrogate",
            keep_top=SURROGATE_KEEP, surrogate=model)
        w["pruned"] = time.perf_counter() - t
        if (list(pruned) != [f"cand{i}" for i in keep]
                or [r.cycles for r in pruned.values()]
                != held_cycles[keep].tolist()):
            raise AssertionError(f"surrogate {name}: the pruned evaluation "
                                 f"did not simulate the ranked names")
        acfg = AnnealConfig(**kw)
        gcfg = dataclasses.replace(acfg, rounds=2 * acfg.rounds)
        torch.cuda.synchronize()
        t = time.perf_counter()
        guided = place.anneal_placement(g, nx, ny, gcfg, guide=model,
                                        guide_margin=0.0)
        w["guided"] = time.perf_counter() - t
        sim = place.evaluate_placements(g, nx, ny,
                                        {"guided": guided.node_pe},
                                        cfgs=cfg)["guided"]
        unguided = acfg.replicas * acfg.rounds * acfg.steps
        ratio = guided.cost_evals / unguided
        print(f"guided {name}: cost {guided.init_cost} -> {guided.cost} "
              f"(BENCH {want['cost']}), cost_evals {guided.cost_evals} of "
              f"{guided.proposals} proposals (BENCH {want['evals']} of "
              f"{want['proposals']}), eval ratio {ratio:.4f} against the "
              f"unguided budget {unguided}, cycles {sim.cycles} (BENCH "
              f"{want['cycles']}; unguided {cycles['annealed']}), search "
              f"wall {w['guided']:.3f} s", flush=True)
        if not (np.array_equal(guided.node_pe, key("guided/node_pe"))
                and np.array_equal(guided.replica_costs,
                                   key("guided/replica_costs"))
                and guided.cost == want["cost"]
                and guided.cost_evals == want["evals"]
                and guided.proposals == want["proposals"]
                and sim.done and sim.cycles == want["cycles"]
                and sim.cycles <= cycles["annealed"] and ratio <= 0.5):
            raise AssertionError(f"guided {name}: differs from BENCH")
        walls[name] = w
    counts = dict(ka.launches, **mk.launches)
    print(f"surrogate kernel launches: {counts}", flush=True)
    for k in ("anneal_guided", "mega_chunk_batched", "mega_chunk_shared"):
        if counts[k] == 0:
            raise AssertionError(f"the surrogate path never launched {k}")
    if counts["mega_chunk_global"]:
        raise AssertionError("a placed memory took the global body")
    return counts, walls


def surrogate_cli():
    """``python -m repro_torch.surrogate --smoke`` on the card, in a process
    of its own; prints its line and seconds."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.surrogate", "--smoke"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    if proc.returncode != 0:
        raise AssertionError(f"the surrogate smoke failed:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    print(f"{proc.stdout.strip()} ({time.perf_counter() - t:.1f} s)",
          flush=True)


def guided_times(torch, np, ka):
    """The guided kernel's device time (profiler) on the timed search
    beside its plain version's (CUDA events) on the same inputs, and at
    each BENCH guided budget (rounds x 2) beside the unguided kernel's at
    the same budget: ms, µs a step and a proposal. Returns the kernels-line
    fields."""
    from repro_torch import surrogate
    from repro_torch.core import prng
    from repro_torch.core import workloads as wl
    from repro_torch.place import anneal as pa
    from repro_torch.place.cost import edge_tables
    from repro_torch.place.spec import AnnealConfig
    from repro_torch.surrogate import delta as sd

    z = np.load(SURROGATE_GOLDEN)

    def inputs(name, acfg):
        args, (nx, ny), *_ = PLACEMENT_ROWS[name]
        g = wl.arrow_lu_graph(*args[:3], seed=args[3])
        src, dst, w_edge, w_node = edge_tables(g)
        tabs = pa.incidence_from_edges(src, dst, w_edge, g.num_nodes)
        init = pa._check_init(None, g.num_nodes, nx * ny, acfg.seed)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
        tensors = (t(init[None]), *map(t, tabs), t(w_node),
                   t(pa._thresholds(acfg)[None]),
                   prng.key(acfg.seed)[None].cuda())
        knobs = dict(nx=nx, ny=ny, rounds=acfg.rounds, steps=acfg.steps,
                     pressure_weight=acfg.pressure_weight)
        ga = sd.guide_arrays(guide_for(np, z, surrogate.build_features(
            g, nx, ny), name, 0))
        return g, tabs, ga, tensors, knobs

    def events_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out)

    name, kw = GUIDED_TIMED
    acfg = AnnealConfig(**kw)
    g, (nbr, w_inc, is_out), ga, tensors, knobs = inputs(name, acfg)
    gk = dict(guide=ga, q_margin=0, guide_every=1)
    search = lambda: ka.anneal_ladders(*tensors, **knobs, **gk)
    ms = kernel_us(torch, search, 5,
                   ("anneal_kernel<true>",))["anneal_kernel<true>"] / 1e3
    call_ms = events_ms(search, 5)
    ga_dev = sd.to_device(ga, "cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = ka.anneal_guided_plain(*tensors, ga_dev, 0, guide_every=1,
                                  **knobs)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    if any(not torch.equal(a, b) for a, b in zip(search(), want)):
        raise AssertionError("the timed guided search differs from its "
                             "plain version")
    steps = acfg.rounds * acfg.steps
    proposals = steps * acfg.replicas
    n, R, P = g.num_nodes, acfg.replicas, knobs["nx"] * knobs["ny"]
    # bytes: each input read once (init, both incidence tables, the weights,
    # the guide's tables and slopes, thresholds, keys), each output written
    # once (every rung's best placement, cost and evals, the init cost)
    guide_bytes = sum(np.asarray(a).nbytes for a in (
        ga.nbr, ga.out_inc, ga.w_inc, ga.c_inc, ga.u_inc, ga.w_node,
        ga.n_unit, ga.w_bucket, ga.gamma_q))
    nbytes = (4 * n + nbr.nbytes + w_inc.nbytes + is_out.nbytes + 4 * n
              + guide_bytes + 8 * R + 16 + 4 * R * n + 16 * R + 8)
    ops = proposals * THREEFRY_OPS
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / SCALAR_OPS_PER_S * 1e3
    out = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               shape=dict(row=name, n=n, grid=[knobs["nx"], knobs["ny"]],
                          margin=0.0, guide_every=1, **kw),
               us_per_step=ms * 1e3 / steps,
               us_per_proposal=ms * 1e3 / proposals,
               plain_us_per_step=plain_ms * 1e3 / steps)
    print(f"guided anneal time {name} R={R} {acfg.rounds}x{acfg.steps}: "
          f"kernel {ms:.3f} ms ({out['us_per_step']:.3f} us a step, "
          f"{out['us_per_proposal']:.3f} us a proposal), search "
          f"{call_ms:.3f} ms, plain {plain_ms:.1f} ms "
          f"({out['plain_us_per_step']:.1f} us a step), bound "
          f"{out['bound_ms'] * 1e3:.3f} us ({out['bound_by']}: bytes "
          f"{bytes_ms * 1e3:.3f} us, operations {ops_ms * 1e3:.3f} us), "
          f"P={P}", flush=True)
    rows = {}
    for row, (_, _, kw_row, _, _) in PLACEMENT_ROWS.items():
        base = AnnealConfig(**kw_row)
        acfg = dataclasses.replace(base, rounds=2 * base.rounds)
        g, (nbr, *_), ga, tensors, knobs = inputs(row, acfg)
        # one profiled search each (the library is loaded by now)
        guided = kernel_us(torch, lambda: ka.anneal_ladders(
            *tensors, **knobs, guide=ga, q_margin=0, guide_every=1), 1,
            ("anneal_kernel<true>",), warmup=False)["anneal_kernel<true>"] / 1e3
        unguided = kernel_us(torch, lambda: ka.anneal_ladders(
            *tensors, **knobs), 1, ("anneal_kernel<false>",),
            warmup=False)["anneal_kernel<false>"] / 1e3
        # both plain versions a step, on one round of 16 steps at the row's
        # shapes
        short = dict(knobs, rounds=1, steps=16)
        ga_dev = sd.to_device(ga, "cuda")
        plain_us = {}
        for tag, fn in (("unguided", lambda: ka.anneal_plain(*tensors,
                                                             **short)),
                        ("guided", lambda: ka.anneal_guided_plain(
                            *tensors, ga_dev, 0, guide_every=1, **short))):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            plain_us[tag] = start.elapsed_time(end) * 1e3 / 16
        steps = acfg.rounds * acfg.steps
        n, D, Dg = g.num_nodes, int(nbr.shape[1]), int(ga.nbr.shape[1])
        P, R = knobs["nx"] * knobs["ny"], acfg.replicas
        # the BENCH budgets' bounds (inputs once, outputs once, against the
        # Threefry operations), unguided at the placement row's budget
        io = {"unguided": 4 * n + 9 * n * D + 4 * n + 8 * R + 16
              + 4 * R * n + 8 * R + 8}
        io["guided"] = io["unguided"] + sum(np.asarray(a).nbytes for a in (
            ga.nbr, ga.out_inc, ga.w_inc, ga.c_inc, ga.u_inc, ga.w_node,
            ga.n_unit, ga.w_bucket, ga.gamma_q)) + 8 * R
        bound = {}
        for tag, nsteps in (("unguided", steps // 2), ("guided", steps)):
            b_ms = io[tag] / HBM_BYTES_PER_S * 1e3
            o_ms = nsteps * R * THREEFRY_OPS / SCALAR_OPS_PER_S * 1e3
            bound[tag] = (max(b_ms, o_ms),
                          "bytes" if b_ms >= o_ms else "operations")
        # what a replica's step touches at least: its incidence row(s), the
        # neighbours' PEs, two loads, a commit; guided also the guide's row
        # (29 bytes an entry), the state's 12P + nx + ny words read and the
        # 29 features read and written
        touched = {"unguided": 13 * D + 24}
        touched["guided"] = (touched["unguided"] + 29 * Dg
                             + 8 * (12 * P + knobs["nx"] + knobs["ny"])
                             + 16 * 29)
        rows[row] = dict(
            ms=guided, unguided_ms=unguided, steps=steps,
            us_per_step=guided * 1e3 / steps,
            us_per_proposal=guided * 1e3 / steps / R,
            unguided_us_per_step=unguided * 1e3 / steps,
            plain_us_per_step=plain_us["guided"],
            unguided_plain_us_per_step=plain_us["unguided"],
            bound_ms=bound["guided"][0], bound_by=bound["guided"][1],
            unguided_bound_ms=bound["unguided"][0],
            unguided_bound_by=bound["unguided"][1],
            touched_bytes_per_step={k: R * v for k, v in touched.items()},
            degree=D, guide_degree=Dg)
        print(f"guided anneal time {row} (BENCH guided budget, "
              f"R={R} {acfg.rounds}x{acfg.steps}): {guided:.2f} ms, "
              f"{rows[row]['us_per_step']:.3f} us a step, "
              f"{rows[row]['us_per_proposal']:.3f} us a proposal; unguided "
              f"kernel {unguided:.2f} ms, "
              f"{rows[row]['unguided_us_per_step']:.3f} us a step; plain "
              f"{plain_us['guided']:.1f} us a step guided, "
              f"{plain_us['unguided']:.1f} unguided (1 x 16 steps); bound "
              f"{bound['guided'][0] * 1e3:.3f} us ({bound['guided'][1]}) "
              f"guided, {bound['unguided'][0] * 1e3:.3f} us "
              f"({bound['unguided'][1]}) unguided at {steps // 2} steps; a "
              f"step touches {R * touched['guided']} bytes guided, "
              f"{R * touched['unguided']} unguided (D {D}, guide D {Dg})",
              flush=True)
    out["rows"] = rows
    return out


def build_all(_build, sources):
    """Compile every source at once, one nvcc each; print ptxas lines."""
    t = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    print(f"build: {', '.join(sources)} in {time.perf_counter() - t:.1f} s",
          flush=True)
    for source in sources:
        _build.library(source)
        print(f"--- {source}\n"
              + _build.build_logs.get(source, "(library already built)").strip(),
              flush=True)


def phase(name, fn, *args):
    """Run one phase and print its seconds."""
    t = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", nargs="+", default=list(SELECT_ROWS),
                    choices=list(ROWS),
                    help="rows of the select main path (default: %(default)s)")
    ap.add_argument("--mega-rows", nargs="+", default=list(MEGA_ROWS),
                    choices=list(ROWS),
                    help="rows of the megakernel main paths, solo and "
                         "batched (default: %(default)s)")
    ap.add_argument("--fig1-full", action="store_true",
                    help="also the BENCH fig1_full placement row (n502447; "
                         "its graph builds in a worker; ~25 s more)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    # The rows' host set-up runs in worker processes while the kernels build
    # and the early phases run; the pool ends with the script.
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        return run_phases(torch, np, args, pool)


def run_phases(torch, np, args, pool) -> int:
    """Every phase, in order; then the kernels line and the last line."""
    from repro_torch.kernels import _build, lod
    from repro_torch.kernels import anneal as ka
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import megakernel as mk

    print(card_line(), flush=True)   # name, power limit as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    graphs = Graphs(pool)
    # fig1_full's graph (a Python elimination loop) builds in a worker too
    fig1_job = pool.submit(fig1_full_setup) if args.fig1_full else None
    rows = list(dict.fromkeys(["n15072", *args.rows, *args.mega_rows,
                               CHUNKING_ROW, PER_CYCLE_ROW]))
    # the first phases need n15072 and (phase 4's 2x2 grid) the largest row
    graphs.prefetch(["n15072", *sorted(rows, key=lambda n: -ROWS[n][0][0])])
    phase("build", build_all, _build, [lod.SOURCE, mk.SOURCE, fa.SOURCE,
                                       ka.SOURCE])

    t = time.perf_counter()
    err = check_kernels(torch, np, lod)
    print(f"kernels equal their plain versions at {KERNEL_SHAPES}", flush=True)
    timed = {}
    for p, w in KERNEL_SHAPES:
        timed[(p, w)] = kernel_times(torch, np, lod, p, w)
        for name, t_ in timed[(p, w)].items():
            print(f"kernel time {name} {p}x{w}: device {t_['ms'] * 1e3:.2f} us "
                  f"(plain {t_['plain_ms'] * 1e3:.2f} us), per call "
                  f"{t_['call_ms'] * 1e3:.2f} us (plain "
                  f"{t_['plain_call_ms'] * 1e3:.2f} us), bytes bound "
                  f"{t_['bytes'] / HBM_BYTES_PER_S * 1e6:.4f} us", flush=True)
    print(f"phase leading-one kernels: {time.perf_counter() - t:.1f} s",
          flush=True)

    mega_err, cases, traced_err, traced_cases = phase(
        "megakernel check", check_megakernel, torch, np, graphs, mk,
        args.mega_rows)
    print(f"megakernel equals its plain version in {cases} cases, max abs "
          f"error {mega_err}; traced in {traced_cases} cases, max abs error "
          f"{traced_err}", flush=True)
    batch_err, batch_cases, t_err, t_cases = phase(
        "batched megakernel check", check_batched_megakernel, torch, graphs,
        mk, args.mega_rows)
    traced_err, traced_cases = max(traced_err, t_err), traced_cases + t_cases
    print(f"batched megakernel equals its plain version in {batch_cases} "
          f"cases, max abs error {batch_err}; traced in {t_cases} cases, max "
          f"abs error {t_err}", flush=True)

    replay_err, replay_cases, t_err, t_cases = phase(
        "replayed chunk check", check_replayed_chunks, torch, graphs, mk)
    print(f"replayed chunks equal the eager chunks in {replay_cases} cases, "
          f"max abs error {replay_err}; traced in {t_cases} cases, max abs "
          f"error {t_err}", flush=True)
    select_results, counts, replays, per_replay = phase(
        "main path select", select_main_path, torch, np, graphs, args.rows,
        lod)
    mega_results, mega_counts = phase("main path megakernel", mega_main_path,
                                      torch, np, graphs, args.mega_rows, mk,
                                      select_results)
    batch_counts = phase("batched main path", batched_main_path, torch, np,
                         graphs, args.mega_rows, mk, mega_results)
    phase("eject rows", eject_rows, torch, np)
    phase("chunking rows", chunking_rows, torch, np, graphs, select_results)
    tel = phase("telemetry", telemetry_phase, torch, np, graphs, mk)
    solo_walls = phase("full-card sweeps", full_card_sweeps, torch, np, graphs,
                       mk)
    phase("batched select", batched_select, torch, np, lod)
    anneal_err, anneal_cases = phase("anneal check", check_anneal, torch, np)
    place_counts, place_walls = phase(
        "placement rows", placement_rows, torch, np, graphs, ka, lod, mk,
        fig1_job)
    anneal_t = phase("anneal time", anneal_times, torch, np, ka)
    guided_err, guided_cases = phase("guided anneal check", check_guided,
                                     torch, np)
    surrogate_counts, surrogate_walls = phase("surrogate rows",
                                              surrogate_rows, torch, np, ka,
                                              mk)
    phase("surrogate smoke", surrogate_cli)
    guided_t = phase("guided anneal time", guided_times, torch, np, ka)

    mega_timed = phase("megakernel time", megakernel_times, torch, graphs, mk)
    scaling = phase("batch scaling", batch_scaling, torch, graphs, mk,
                    solo_walls["sweep_ooo"])
    nodes, replay_runs = phase("profiles", profiles, torch, graphs)
    flash = lm_phases(torch, np)

    line = []
    for name, replaces in KERNELS.items():
        t_ = timed[TIMED_SHAPE][name]
        row = dict(
            name=name, route="cuda", source=SOURCE, replaces=replaces,
            launches=counts[name], max_abs_err=err[name],
            equal=err[name] == 0, ms=t_["ms"],
            plain_ms=t_["plain_ms"], bound_ms=t_["bytes"] / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None, call_ms=t_["call_ms"],
            shape=list(TIMED_SHAPE))
        if name in LOD_KERNELS:
            # On the main path: launched from replays of captured chunks.
            run = next(r for (_, p, e), r in replay_runs.items()
                       if e == "select" and r["per_replay"].get(name))
            us = nodes.get(name, (None, 0))[0]
            row.update(
                in_graph_ms=None if us is None else us / 1e3,
                replays=replays, launches_per_replay=per_replay[name],
                replay_call_ms=run["host_ms"],
                replay_host_ms_per_op=run["host_ms"] / run["ops_per_replay"])
        line.append(row)
    first = MEGA_TIMED_ROWS[0]
    mt = mega_timed[first, "ooo", ""]
    line.append(dict(
        name="mega_chunk", route="cuda", source=MEGA_SOURCE,
        replaces=MEGA_REPLACES, launches=mega_counts["mega_chunk"],
        max_abs_err=mega_err, equal=mega_err == 0, ms=mt["ms"],
        plain_ms=mt["plain_ms"], bound_ms=mt["bytes"] / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None, call_ms=mt["call_ms"],
        shape=mt["shape"], K=MEGA_K, body="shared",
        body_launches=mega_counts["mega_chunk_shared"]))
    gt = mega_timed[first, "ooo", "global body"]
    line.append(dict(
        name="mega_chunk_global", route="cuda", source=MEGA_SOURCE,
        replaces=MEGA_REPLACES + " (grids the shared body does not take)",
        launches=mega_counts["mega_chunk_global"]
        + batch_counts["mega_chunk_global"], max_abs_err=max(mega_err,
                                                             batch_err),
        equal=max(mega_err, batch_err) == 0, ms=gt["ms"],
        plain_ms=mt["plain_ms"], bound_ms=gt["bytes"] / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None, call_ms=gt["call_ms"],
        shape=gt["shape"], K=MEGA_K, body="global"))
    line.append(dict(
        name="mega_chunk_traced", route="cuda", source=MEGA_SOURCE,
        replaces=MEGA_TRACED_REPLACES, launches=tel["launches"],
        max_abs_err=traced_err, equal=traced_err == 0, ms=tel["ms"],
        plain_ms=tel["plain_ms"],
        bound_ms=tel["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, call_ms=tel["call_ms"], shape=tel["shape"],
        K=MEGA_K, body="shared", traced_ms=tel["traced_ms"],
        untraced_ms=tel["untraced_ms"], cases=traced_cases,
        spec="TelemetrySpec()", walls_s=tel["walls"]))
    bt = scaling[BATCH_TIMED_B]
    line.append(dict(
        name="mega_chunk_batched", route="cuda", source=MEGA_SOURCE,
        replaces=MEGA_REPLACES + " (batched=True)",
        launches=batch_counts["mega_chunk_batched"], max_abs_err=batch_err,
        equal=batch_err == 0, ms=bt["ms"], plain_ms=bt["plain_ms"],
        bound_ms=bt["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, call_ms=bt["call_ms"], shape=bt["shape"], K=MEGA_K,
        body="shared", body_launches=batch_counts["mega_chunk_shared"]))
    line.append(flash)
    line.append(dict(
        name="anneal", route="cuda", source=ANNEAL_SOURCE,
        replaces=ANNEAL_REPLACES, launches=place_counts["anneal"],
        max_abs_err=anneal_err, equal=anneal_err == 0, ms=anneal_t["ms"],
        plain_ms=anneal_t["plain_ms"], bound_ms=anneal_t["bound_ms"],
        bound_by=anneal_t["bound_by"], library_ms=None,
        call_ms=anneal_t["call_ms"], shape=anneal_t["shape"],
        cases=anneal_cases,
        us_per_step=anneal_t["us_per_step"],
        us_per_proposal=anneal_t["us_per_proposal"],
        plain_us_per_step=anneal_t["plain_us_per_step"],
        rows=anneal_t["rows"], search_walls_s=place_walls,
        placement_launches={k: place_counts[k] for k in (
            "schedule_step", "mega_chunk_batched", "mega_chunk_shared",
            "mega_chunk_global")}))
    line.append(dict(
        name="anneal_guided", route="cuda", source=ANNEAL_SOURCE,
        replaces=GUIDED_REPLACES,
        launches=surrogate_counts["anneal_guided"], max_abs_err=guided_err,
        equal=guided_err == 0, ms=guided_t["ms"],
        plain_ms=guided_t["plain_ms"], bound_ms=guided_t["bound_ms"],
        bound_by=guided_t["bound_by"], library_ms=None,
        call_ms=guided_t["call_ms"], shape=guided_t["shape"],
        cases=guided_cases, us_per_step=guided_t["us_per_step"],
        us_per_proposal=guided_t["us_per_proposal"],
        plain_us_per_step=guided_t["plain_us_per_step"],
        rows=guided_t["rows"], walls_s=surrogate_walls,
        surrogate_launches={k: surrogate_counts[k] for k in (
            "mega_chunk_batched", "mega_chunk_shared",
            "mega_chunk_global")}))
    # The card's line again, where a reader of the output's tail finds it.
    print(card_line(), flush=True)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
