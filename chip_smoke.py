#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                   # everything, as the check runs it
    python3 chip_smoke.py --rows n15072 --mega-rows n15072   # smallest rows
    python3 chip_smoke.py --full-checks     # every case of phases 4-5b, 10e

By default phases 4, 5 and 5b hold the kernels to their plain versions at
the main path's eject configuration (``n_first``, capacity 1) wherever
``tests/test_torch_cuda.py`` holds the other two on the matrix graph, and
the 2x2 mesh of phase 10e leaves out the tensor engine's two runs (its
``megakernel`` run runs the same chunk); ``--full-checks`` runs every case
(minutes more). The CLIs of phases 8d, 10c and 10d run one after
another in a thread while phases 4 to 5b run (nothing there is timed) and
are read before phase 6; phase 21b's three dry-run processes start beside
them and are read after phase 21.

Phases, each of which fails the run on any error (each prints its seconds):
  1. the card: its name and power limit from ``nvidia-smi``;
  2. build: compiles every CUDA source of the port (``lod.cu``,
     ``megakernel.cu``, ``flash_attention.cu``, ``anneal.cu``) with
     ``nvcc``, one process per source, all started together (set-up); the
     phase waits for ``lod.cu``, phase 4 for ``megakernel.cu``, the CLIs'
     thread and phase 10b for ``anneal.cu``, the big goldens after phase
     5b for ``flash_attention.cu`` (each wait a phase of its own), and each
     source's seconds and ``ptxas -v`` lines are printed when it is waited
     for;
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
     runs. Without ``--full-checks``: the matrix graph on 2x2 and 64x64 and
     n15072 on 16x16 at ``n_first_cap1`` only;
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
     too. Without ``--full-checks`` the mixed batches run at n_first only
     and traced only, and the two full-card sweeps (126-128
     elements) from their states three cycles before the ends only, at
     K = 7;
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
     captured graph records the trace updates. Without ``--full-checks``:
     n_first only, the mixed batch traced only;
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
     repro_torch.telemetry --fig1`` (run beside phases 4 to 5b) having
     written two Perfetto traces of ``track_count`` tracks; the traced
     megakernel launched; then the traced and untraced chunk's device
     time at n15072 ``ooo`` in turns,
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
     time (profiler; CUDA events around the call where three profiled runs
     record no launch) beside its plain version's on a short search, and at
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
     ``shared`` body. Then ``python -m repro_torch.surrogate --smoke``'s
     output, which ran in a process of its own while phases 4 to 5b ran,
     and the guided kernel's device time (profiler, or
     events as in 10b) beside its plain version's on a short search, and at each BENCH guided
     budget beside the unguided kernel's (µs a step and a proposal);
 10d. service: the placement service (``repro_torch.service``), counted:
     the BENCH ``service`` stream (``service_stream(32, 8, seed=0)``, 4x4,
     budget 2048, ``placement="anneal"``, ``select``) through one
     ``PlacementService``: the cold stream, the warm all-hit replay and a
     fresh service per distinct graph, the 8 ``cycles_anneal`` (510 / 679 /
     895 / 1117, seeds 1 and 2 equal), cached = fresh, 24 hits, 8 misses,
     8 simulations, 8 anneals, 0 batched, hit rate 0.75; the same fresh
     queries under ``megakernel`` (same keys, placements, cycles and
     stats); ``explore`` on the first graph over
     ``service_bench.FRONTIER_SPACE``: 2 of 8 points, 937 (2x2) and 418
     (4x4); three anneal seeds in one ``run_batch`` (one anneal launch)
     equal to three solo queries (three launches) row for row; two guided
     queries sharing one surrogate (one fit); ``schedule_step``, the
     batched megakernel, the anneal kernel and its ``GUIDED``
     instantiation must have launched. Then the output of ``python -m
     repro_torch.core.workloads megakernel_bench``, ``python -m
     repro_torch.kernels --smoke`` (every policy's megakernel run equal to
     the tensor engine's, one launch a chunk; n15072 2125 / 2369) and
     ``python -m repro_torch.service --smoke``, each of which ran in a
     process of its own while phases 4 to 5b ran;
 10e. sharded: ``repro_torch.run(..., mesh=)`` (``core/distributed.py``).
     (a) A 1x1 mesh in this process over NCCL (a world of one, a
     ``FileStore`` rendezvous in a temporary directory), counted: n15072
     ``ooo`` and ``inorder`` under ``select`` and ``megakernel``, the
     reference's batch (``ooo``, ``inorder``, ``scan`` at a budget of 200)
     under ``megakernel`` on the criticality-ordered memory, ``ooo`` traced
     (``TelemetrySpec()``) under ``megakernel`` and n470772 ``ooo`` under
     ``megakernel``: each equal to its non-mesh run leaf for leaf (traces
     included), at the goldens (2125 / 2369, 54943); kernels 2, 4, 4b and 4t
     must have launched through the mesh path, and no collective. (b) A 2x2
     mesh of four gloo ranks spawned on the one card (each tile on
     ``cuda:0``; halo edges and reduces staged through pinned host
     buffers): n15072 ``ooo`` and ``inorder`` under ``select`` (and under
     ``tensor`` with ``--full-checks``), and ``ooo`` under ``megakernel``
     (which runs the tensor chunk on a multi-shard mesh; the line names the
     chunk that ran), every
     rank equal to the non-mesh run bit for bit; each run's wall, simulated
     cycles/s, halo exchanges and µs a cycle, reduces, the route and kernel
     2's launches;
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
     capture, the replays with the host's read of ``done`` after each) for
     its first 640 cycles; over 20 replays of the captured chunk back to
     back (n15072 ``ooo`` select, n29772 ``lru_flat`` select, n15072
     ``ooo`` tensor),
     each beside its device and host time per chunk (CUDA events), with
     each leading-one kernel's device us per launch inside the replay
     (PERF.md holds an empty kernel's node time, measured once, beside
     it); over the whole n15072 ``ooo`` megakernel run, over
     its chunk loop alone (``run_state`` on a state built beforehand) and
     over the whole n470772 ``ooo`` megakernel run, each with its device busy
     share, device ops per cycle and top kernels (the profiler records the
     card's activity only: the host's ops would multiply the events it
     sorts, and nothing reads them);
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
     2080), and deepseek-v2-lite's MLA shapes at head_dim 192 with v's
     last 64 columns zero and ``scale = 192 ** -0.5`` (the prefill, batch 8
     x 2048 tokens, 16 heads; an 8-token prompt on ``split``; Tq 33 and
     2047), zamba2-7b's shared attention (32 heads of 112: the ``mma`` body
     pads them to 128) and qwen2-vl-72b's (64 q over 8 kv heads of 128),
     each at its serve prefill (batch 8 x 2048) and decode (a 2080-key
     cache, ragged fill levels), gemma-2b's (8 q heads over one kv head of
     256), minicpm-2b's (36 heads of 64, MHA), starcoder2-7b's (36 over 4
     heads of 128: a group of 9 rows) and dbrx-132b's (48 over 8 heads of
     128) the same way, and whisper-large-v3's five calls at its
     serve shapes (20 heads of 64; batch 8): the encoder's non-causal
     1,500 x 1,500, the decoder's causal 750 x 750 prefill, the non-causal
     cross-attention of 750 queries over 1,500 keys, and a decode step's
     causal self-attention over up to 782 keys (ragged) and non-causal
     cross-attention over 1,500; then the mma body's exponential
     (ex2.approx) against expf on the prefill case's scores, within half a
     bf16 step;
 15. flash-attention time: device time at the prefill and decode shapes in
     bfloat16 (CUDA-graph replay) and at deepseek-v2-lite's MLA prefill
     (head_dim 192), at zamba2-7b's, qwen2-vl-72b's, gemma-2b's,
     minicpm-2b's, starcoder2-7b's and dbrx-132b's prefill and decode and
     at whisper-large-v3's five shapes (decode over a full cache),
     each body kernel's time by the profiler (the simt
     body's at qwen2-0.5b's and the MLA prefill in float32), beside the
     plain version's,
     SDPA's (the yardstick, with an explicit mask and without one), the
     host time per call and the bound (FLOPs at 989 TFLOP/s or bytes at
     3.35 TB/s, whichever is larger; head_dim 192 counted as 192, not the
     256 the mma body pads its tiles to);
 16. serve main path: ``repro_torch.launch.serve.main`` for qwen2-0.5b at
     full width in bfloat16, batch 8 x 2048 prompt tokens, 32 new tokens
     (after a warm-up run of 2 new tokens): prefill and decode tok/s, and
     the flash kernel called exactly 24 x 32 times in the counted run: 24
     ``mma`` launches, 744 ``split`` and 744 ``combine``, no ``simt``;
 16b. serve deepseek: ``serve.main`` for deepseek-v2-lite-16b at full width
     and depth (27 layers, MLA, 64 routed experts top-6 + 2 shared, layer 0
     dense) in bfloat16, batch 8 x 2048 prompt tokens, 32 new tokens (after
     a warm-up run of 2): prefill and decode tok/s, the prefill's
     ``moe_dropped``, the peak device memory, and the flash kernel called
     once a layer in the prefill on the body ``plan`` gives (27 ``mma``)
     and never in decode (MLA's absorbed decode launches no kernel);
 16c. serve the SSM, hybrid and VLM families: ``serve.main`` for
     mamba2-130m (24 Mamba2 layers) and zamba2-7b (70 Mamba2 layers, 11
     applications of one shared attention block) at full width and depth,
     and qwen2-vl-72b at full width cut to 16 layers (``--layers 16``;
     from stub patch embeddings), bf16, batch 8 x 2048, 32 new tokens
     (after a warm-up run of 2): prefill and decode tok/s, peak device
     memory, and the flash kernel's launches by body against the count
     expected (printed first): none for mamba2; for zamba2 one an
     application, 11 ``mma`` in the prefill and 11 x 31 ``split`` +
     ``combine`` in decode; for qwen2-vl 16 and 16 x 31;
 16d. serve whisper: ``serve.main`` for whisper-large-v3 at full width and
     depth (32 encoder and 32 decoder layers) in bf16, batch 8, 1,500
     frames (twice the prompt, as the reference's serve draws them), a
     750-token prompt, 32 new tokens (after a warm-up run of 2): prefill and
     decode tok/s, peak device memory, and the flash kernel's launches by
     body against the count ``plan`` gives (printed first), which must be
     96 ``mma`` (32 encoder, 32 self- and 32 cross-attention prefill
     calls), 1,984 ``split`` and 1,984 ``combine`` (31 steps x 32 layers x
     self and cross) and no ``simt``;
 16e. serve the four registry archs not served before: ``serve.main`` for
     gemma-2b (18 layers), minicpm-2b (40) and starcoder2-7b (32) at full
     width and depth and dbrx-132b at full width cut to 8 of its 40 layers
     (``--layers 8``; 16 experts top-4 at capacity factor 1.25), bf16,
     batch 8 x 2048, 32 new tokens (after a warm-up run of 2): prefill and
     decode tok/s, peak device memory, the prefill's ``moe_dropped``, the
     wall, and the flash kernel's launches by body against the count
     ``plan`` gives (one ``mma`` a layer in the prefill, one ``split`` and
     one ``combine`` a layer and decode step: 18 / 558 / 558, 40 / 1,240 /
     1,240, 32 / 992 / 992 and 8 / 248 / 248);
 17. serve consistency: full width in float32 (TF32 off), prefill (on the
     ``simt`` body) and 16 teacher-forced decode steps (``split``) through
     the kernel against ``forward``'s logits, and against the same steps
     with the plain attention on the card, at 3e-4;
 18. against the reference: the numpy recipe's weights in float32, a
     prefill and three decode steps at full width; top-32 logits (indices
     and values) and logsumexp against the golden the JAX package made
     (``tests/fixtures/qwen2_0_5b_golden.npz``), at 1e-4;
 18b. against the reference in bf16: phase 18j's check of qwen2-0.5b
     (below), right after phase 18 from its weights;
 18c. deepseek against the reference: the numpy recipe's weights in
     float32 at full width and depth 2 (layer 0 dense, layer 1 MoE), a
     prefill of 2 x 64 tokens and three decode steps against the JAX
     package's golden (``tests/fixtures/deepseek_v2_lite_golden.npz``):
     top-32 logits and logsumexp at 1e-4, and the MoE layer's prefill
     routing (each token's top-6 experts and the capacity cut's keep
     mask) equal but for near-ties (the golden's own gap below 1e-5),
     which are counted; then deepseek at full width and depth 4 in float32
     with capacity factor 8 (nothing drops): prefill and 16 teacher-forced
     decode steps against ``forward``'s logits at 3e-4;
 18d. the SSM goldens: mamba2-130m at full width and depth and zamba2-7b at
     full width and depth 7 (6 Mamba2 layers, one shared-block
     application), float32 (TF32 off), the numpy recipe's weights, a
     prefill of 2 x 300 tokens (past one SSD chunk of 256) and three
     decode steps against the JAX package's goldens
     (``tests/fixtures/mamba2_130m_golden.npz``, ``zamba2_7b_golden.npz``):
     top-32 logits and logsumexp at 1e-4, and the flash launches (zamba2:
     ``simt`` in the prefill, ``split`` in decode);
 18e. qwen2-vl consistency: qwen2-vl-72b at full width and depth 2 in
     float32, ``forward`` over 64 stub embeddings followed by the table
     rows of 8 tokens against a prefill of the 64 embeddings and decode
     steps of those tokens, at 3e-4 (held to the reference's golden in
     18h);
 18f. whisper against the reference: whisper-large-v3 at full width and
     depth in float32 (TF32 off), the numpy recipe's weights (~6.1 GB), the
     encoder over 2 x 150 frames (ragged key tiles on the non-causal
     ``simt`` path), a prefill of 75 tokens and three decode steps against
     the JAX package's golden (``tests/fixtures/whisper_large_v3_golden.npz``):
     top-32 logits and logsumexp at 1e-4, and the launches (96 ``simt``,
     then ``split``); then the same model's prefill of 32 tokens and 16
     teacher-forced decode steps against ``forward_encdec``'s logits at
     3e-4;
 18g. sampled decoding: 8 sampled decode steps of qwen2-0.5b at full width
     in bf16 (batch 8, temperature 0.8, the key of step i ``fold_in(key(11),
     i)``): each step's Threefry bits and uniforms (JAX's partitionable
     layout) drawn on the card equal to the same draws on the CPU bit for
     bit, and each token equal to ``argmax(logits / T + gumbel)`` computed
     on the CPU from the card's logits; the host time of a sampled and a
     greedy step;
 18h. the registry goldens: gemma-2b at full width and depth 4,
     minicpm-2b at depth 8 and starcoder2-7b at depth 2 in float32 (TF32
     off), the numpy recipe's weights (drawn on the host while phase 14
     runs), a prefill of 2 x 300 tokens (``simt``) and three decode steps
     (``split``) against the JAX package's goldens
     (``tests/fixtures/gemma_2b_golden.npz``, ``minicpm_2b_golden.npz``,
     ``starcoder2_7b_golden.npz``): top-32 logits and logsumexp at 1e-4,
     and the launches ``plan`` gives. The same, run after phase 5b, for
     qwen2-vl-72b at full width and depth 2 (M-RoPE on the text
     positions the reference's serve gives tokens;
     ``qwen2_vl_72b_golden.npz``) and dbrx-132b at full width and depth 1
     (``dbrx_132b_golden.npz``), whose MoE layer's prefill routing must
     also be the golden's but for near-ties (gap below 1e-5), which are
     counted; their weights (~35 GB in f32, more than the host's half with
     the others' trees) are drawn into the card leaf by leaf, no tree on
     the host, on 4 threads and a CUDA stream of their own while phases 4
     to 5b run; the host's MemTotal and the script's peak RSS are printed;
 18i. dbrx consistency: dbrx-132b at full width and depth 2 in float32
     (~31 GB on the card; weights from a card generator), capacity factor
     4 (nothing drops): prefill and 16 teacher-forced decode steps through
     the kernel against ``forward``'s logits and against the same steps
     with the plain attention, at 3e-4, and each MoE layer's prefill
     routing (top-4 experts, keep mask) equal to the plain run's but for
     near-ties (gap below 1e-5), which are counted;
 18j. the bf16 goldens: every registry arch in bfloat16 (the serve
     path's dtype) at its f32 golden's width and depth, right after its
     f32 check (phases 18, 18c, 18d, 18f, 18h) from the f32 model's
     weights on the card, each rounded to bf16 as the port rounds a leaf,
     against the JAX package's bf16 golden of the same recipe, seed and
     tokens (``tests/fixtures/*_golden_bf16.npz``): the prefill on the
     serve path's ``mma`` body (MLA's too), each decode step on ``split``
     + ``combine``, whisper's through its encoder and cross cache, the
     launches those ``plan`` gives (never ``simt``); per row, the logits
     at the golden's top-32 indices, its own top-32 values and its
     logsumexp within the arch's tolerance x (|golden| + the row's RMS)
     (``GOLDEN_BF16_TOLS``, each between the clean port's reading and its
     reading with one fault injected: the causal mask dropped in the
     first attention layer's prefill; the first layer's D skip dropped
     where it is a Mamba2 layer, expert 0 zeroed where it is a MoE
     layer). The MoE archs' router probabilities at the golden's top-k
     may move by up to 7.5e-3 (``ROUTE_MOVE_BF16``), and their routing, of
     the prefill and of each decode step, must be the golden's but for
     near-ties of its router probabilities within twice that
     (``ROUTE_TIE_BF16``), which are counted; a logit row whose token took
     other experts than the golden's is left out and counted;
 19. serve profiles: ``torch.profiler`` over one prefill of phase 16's
     shape and over 8 decode steps after it, each with its device busy
     share, device ops per step and top kernels; then the same over one
     deepseek-v2-lite prefill of phase 16b's shape and 4 decode steps, over
     one zamba2-7b prefill of phase 16c's shape and 4 decode steps, and over
     one whisper-large-v3 prefill of phase 16d's shape and 4 decode steps;
 20. training at full width: ``repro_torch.launch.train.main`` trains
     qwen2-0.5b at full width and depth (bf16 parameters, f32 master
     weights, WSD AdamW, warmup 4) on ``SyntheticZipfLM`` batches of 8 x
     1,024 tokens for 20 steps, with one async checkpoint at the last
     step: every loss finite, the mean of the last 5 at most 0.9 of the
     first 5's, kernel 5 launched 0 times (training takes the
     differentiable form of attention); ms a step, tok/s, peak device
     memory and the checkpoint's bytes and seconds;
 20b. training against the reference: qwen2-0.5b at full width and depth
     in float32 (TF32 off), the numpy recipe's weights and the copy task's
     batch, against the JAX package's training golden
     (``tests/fixtures/qwen2_0_5b_train_golden.npz``): the loss and its
     metrics, the gradient's global and per-leaf norms, sliced gradients
     and the sliced weights after one AdamW step; then ``grad_accum=2``
     against the full batch at the reference test's thresholds;
 20c. every family trains on the card: one train step of each registry
     arch's smoke config in float32 on the card and on the CPU from the
     same weights and batch (the loss, every gradient and every parameter
     after the step within a stated tolerance: the MoE dispatch, MLA, the
     SSD scan, M-RoPE, the hybrid's shared block and whisper's
     cross-attention under autograd on CUDA); then the driver on the
     qwen2-0.5b smoke config crashed by ``--sim-fail`` and restarted: the
     restored state equal to the saved one and the resumed run's
     parameters equal to the uninterrupted run's, bit for bit;
 20d. sharded training on a 1x1 mesh: the driver with ``--distributed
     --mesh local`` over NCCL (a world of one) on phase 20's arguments for
     5 steps: the losses equal phase 20's first 5 bit for bit, no
     collective, kernel 5 launched 0 times, and its checkpoint restored
     into a one-device state equal to the sharded state bit for bit; ms a
     step, peak memory and the route;
 20e. sharded training on a 2x2 mesh: four gloo ranks spawned on
     ``cuda:0`` train qwen2-0.5b at full width and depth (``fsdp=True``,
     bf16 with f32 master weights) for 3 steps of 4 x 1,024 zipf tokens
     from the state a 1x1 run of the same steps starts from: every block's
     shape as ``to_shardings`` gives it, the losses, gradient norms and
     f32 master weights (every rank's blocks) within stated tolerances of
     the 1x1 run's; per rank ms a step, peak memory, the collectives' count and
     bytes and the route;
 21. sharded serve on a 1x1 mesh: phase 16's serve (qwen2-0.5b at full
     width and depth, bf16, weights from seed 0, batch 8 x 2048 prompt
     tokens, 32 new tokens) through ``make_sharded_prefill_step`` and
     ``make_sharded_decode_step`` over NCCL (a world of one): every step's
     logits and every token equal to the one-device steps' (``serve.main``'s,
     run first on the same weights) bit for bit, kernel 5 launched as in
     phase 16 (24 ``mma``, 744 ``split`` and 744 ``combine``, counted around
     the sharded run), no collective; then the dry-run's count of the same
     run on fake tensors (its argument and peak bytes) beside the
     allocator's, printed side by side with no bound;
 21b. the dry-run on the card host: ``python -m repro_torch.launch.dryrun``
     in three processes, started before phase 4 (while the untimed checks
     of phases 4 to 5b run) and read after phase 21
     (qwen2-0.5b at every shape on the 256-rank mesh, deepseek-v2-lite-16b
     at ``prefill_32k`` on it, qwen2-0.5b at ``train_4k`` on the 512-rank
     mesh; the fake tensors on the card, nothing allocated): each record's
     status and wall, every applicable cell ``OK`` with its argument bytes
     and ``model_flops_total`` equal to the reference's
     (``tests/fixtures/dryrun_reference.json``), its per-rank FLOPs, bytes,
     collective traffic and peak.

Each graph is built once (numpy set-up, in worker processes while the
kernels build) and shared by the phases; phase 10e's four ranks build
n15072 themselves. The card's line is printed again
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
import tempfile
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
#: The main path's eject configuration (``OverlayConfig``'s default): the
#: one the default checks run where the card tests hold the other two.
MAIN_EJECT = "n_first_cap1"
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


def telemetry_cli(out):
    """``python -m repro_torch.telemetry --fig1`` writing into ``out``, with
    a graph cache of its own there: (module arguments, line, environment)
    for ``run_clis``."""
    return (["repro_torch.telemetry", "--fig1", "--out", out], None,
            {"REPRO_GRAPH_CACHE": os.path.join(out, "cache")})


def telemetry_phase(torch, np, graphs, mk, cli_out, cli_wall):
    """Phase 7c, the traced main path. TELEMETRY_ROW ``ooo`` and
    ``inorder`` with ``TelemetrySpec()`` under ``select`` and
    ``megakernel``, each beside its untraced run: the same results, every
    BENCH ``telemetry`` value, the two engines' traces bit-identical and the
    select traces equal to a CPU run of the port; both policies as one
    traced megakernel batch, each element equal to its solo run; the
    per-cycle trace of PER_CYCLE_ROW ``ooo`` under both engines,
    bit-identical, each leaf's sum equal to its counter; the Fig. 1 traces
    that the CLI (``telemetry_cli``, run beside phases 4 to 5b in
    ``cli_wall`` seconds) wrote into ``cli_out``. The launch counts are set
    to 0 before the runs and read after them. Then the traced and untraced
    chunk's device time at TELEMETRY_ROW ``ooo``, in turns. Returns the
    numbers."""
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
    # The CLI's Fig. 1 traces as Perfetto JSON (it ran on the card).
    want = track_count(spec, 16, 16)
    files = sorted(f for f in os.listdir(cli_out) if f.endswith(".json"))
    for f in files:
        with open(os.path.join(cli_out, f)) as fh:
            events = json.load(fh)["traceEvents"]
        tracks = {(e["pid"], e["name"]) for e in events if e["ph"] == "C"}
        if len(tracks) != want:
            raise AssertionError(f"{f}: {len(tracks)} tracks, not {want}")
    print(f"telemetry CLI --fig1: {files}, {want} counter tracks each, "
          f"{cli_wall:.1f} s (beside phases 4 to 5b)", flush=True)
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


def check_megakernel(torch, np, graphs, mk, rows, full=False):
    """The megakernel chunk against its plain version on clones of one
    state, every leaf and the done trace as bit patterns: every policy x
    eject configuration on the small matrix graph and on n15072, the
    matrix graph on grids above 1024 PEs, and the main-path policies of the
    larger megakernel ``rows``. Every grid runs untraced and traced (the
    trace leaves of its spec in ``TRACE_SPECS`` held bit for bit too).
    Unless ``full``, the matrix graph on 2x2 and 64x64 and n15072 on 16x16
    run MAIN_EJECT only (``tests/test_torch_cuda.py`` holds the others on
    the matrix graph). Returns the largest abs error and the number of
    cases, and those of the traced variant."""
    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import (OverlayConfig, device_graph,
                                          init_state, run_state)
    from repro_torch.core.partition import build_graph_memory

    b, s, w, seed = MATRIX_GRAPH
    matrix = wl.arrow_lu_graph(b, s, w, seed=seed)
    n15072, _ = graphs.graph("n15072")
    some = tuple(EJECTS) if full else (MAIN_EJECT,)
    grids = [("matrix 2x2", matrix, 2, 2, POLICIES, some, "small"),
             ("n15072 16x16", n15072, 16, 16, POLICIES, some, "default"),
             ("n15072 2x2", n15072, 2, 2, POLICIES, ("n_first_cap1",), None),
             ("matrix 36x36", matrix, 36, 36, ("ooo",), ("n_first_cap1",),
              "partial"),
             ("matrix 42x42", matrix, 42, 42, ("inorder",), ("cap2",),
              "partial"),
             ("matrix 48x48", matrix, 48, 48, ("ooo",), ("n_first_cap1",),
              "small"),
             ("matrix 64x64", matrix, 64, 64, POLICIES,
              ("n_first_cap1", "cap2") if full else (MAIN_EJECT,), None)]
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


def check_batched_megakernel(torch, graphs, mk, rows, full=False):
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
    n15072 at n_first). Unless ``full`` the mixed batches run at MAIN_EJECT
    only and traced only (``tests/test_torch_cuda.py`` holds the matrix
    graph's untraced at every eject configuration; every main-path batch
    below holds the untraced kernel on the 16x16 grid), and the two
    full-card sweeps (above SMALL_B elements) from their states three
    cycles before the ends only, at K = 7. Returns (max abs error, cases)
    and those of the traced variant."""
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
    if not full:
        runs = [r for r in runs if r[2] == MAIN_EJECT and r[3] is not None]
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
        t = time.perf_counter()
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
        if not full and len(cfgs) > SMALL_B:
            # The full-card sweeps (the plain version loops over 126-128
            # elements): their last cycles only, at K = 7.
            del states["half-way"]
            ks = (7,)
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
              f"and a tail launch); {time.perf_counter() - t:.1f} s",
              flush=True)
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


def check_replayed_chunks(torch, graphs, mk, full=False):
    """Phase 5b: the ``tensor`` and ``select`` engines' chunk replayed from
    its captured CUDA graph against the eager chunk (``make_chunk_fn``,
    ``make_batch_chunk_fn``) on clones of one state: both engines, every
    policy x eject configuration on the matrix graph (2x2) and on n15072
    (16x16) from phase 4's four states, and phase 10's mixed batch on the
    matrix graph (each eject configuration; cycle 0, mid-run, three cycles
    before each element's end, signed zeros), at K = 7 and the engine's own
    K. Traced too, at n_first: every policy on the matrix graph and the
    mixed batch (the ``small`` spec) and n15072 ``ooo`` (the ``default``
    spec), so the capture records the trace updates. Unless ``full``:
    MAIN_EJECT only, the mixed batch traced only (``tests/test_torch_cuda.py``
    holds the matrix graph's chunks, solo and batched, at every eject
    configuration). Returns
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
                if not (full or eject == MAIN_EJECT):
                    continue
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
    runs = ([(eject, None) for eject in EJECTS] if full else []) + [
        ("n_first_cap1", "small")]
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
    # The card's activity only: the host's ops would multiply the events
    # that key_averages sorts, and nothing here reads them.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
#: Cycles of the profiled select chunk loop (``run_state``): 40 chunks of
#: 16, about a third of the n15072 ``ooo`` run.
SELECT_LOOP_CYCLES = 640


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
    # beforehand): the capture and the replays with the host's read of
    # `done` after each, over its first SELECT_LOOP_CYCLES cycles (the
    # profiler's own time grows with the device ops it records).
    select = OverlayConfig(scheduler="ooo", engine="select",
                           max_cycles=SELECT_LOOP_CYCLES)
    g = overlay.device_graph(gm)
    built = [overlay.init_state(g, select) for _ in range(3)]
    torch.cuda.synchronize()
    profile_run(torch, lambda: overlay.run_state(g, select, built.pop()),
                SELECT_LOOP_CYCLES, f"n15072 ooo select (chunk loop: "
                f"run_state on a built state, its first {SELECT_LOOP_CYCLES} "
                f"cycles)")
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
#: deepseek-v2-lite-16b at full width and depth, served as phase 16 serves
#: qwen2-0.5b: 27 MLA layers, each one flash call in the prefill (the body
#: ``plan`` gives at batch 8 x 2048 tokens, 16 heads, head_dim 192) and
#: none in decode (the absorbed form).
DEEPSEEK = "deepseek-v2-lite-16b"
DEEPSEEK_SERVE_ARGS = ["--arch", DEEPSEEK, "--batch", "8", "--prompt-len",
                       "2048", "--gen", "32"]
DEEPSEEK_GOLDEN = ROOT / "tests" / "fixtures" / "deepseek_v2_lite_golden.npz"
#: A routing difference from the golden passes only where the golden's own
#: gap there (between neighbouring router probabilities, or between the
#: criticality keys on either side of an expert's capacity cut) is below
#: this.
ROUTE_TIE = 1e-5
#: The f32 consistency check at full width: layers, capacity factor (no
#: drops at the check's lengths).
DEEPSEEK_CONSIST = (4, 8.0)
#: Kernel checks: name -> (b, hq, hkv, tq, tkv, d, causal, kv_len, layout,
#: (body in float32, body in bfloat16)). The reference's five kernel-test
#: shapes (tests/test_kernels.py, in the Pallas kernel's [B, H, T, D]
#: layout), the main path's prefill and decode (ragged cache fill levels, 1,
#: 64, 65 and Tkv among them), gemma-2b's head_dim 256 under MQA, and the
#: tensor-core body at awkward shapes: Tq not a multiple of 64 (33, 2047),
#: Tkv not a multiple of the key tile (70, 2049), head_dim 80, 128 and 256,
#: non-causal, Tq < Tkv, ragged kv_len.
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
#: deepseek-v2-lite's MLA attention (phase 16b's prefill, an 8-token prompt,
#: Tq 33 and 2047): q and k [nope 128, rope 64], v's 128 columns padded to
#: 192 with zeros (``MLA_V``), ``scale = 192 ** -0.5``.
MLA_CASES = {
    "deepseek_prefill": (8, 16, 16, 2048, 2048, 192, True, None, "tokens",
                         PREFILL),
    "deepseek_prompt8": (8, 16, 16, 8, 8, 192, True, None, "tokens", DECODE),
    "mla_tq33": (2, 16, 16, 33, 33, 192, True, None, "tokens", PREFILL),
    "mla_tq2047": (1, 16, 16, 2047, 2047, 192, True, None, "tokens",
                   PREFILL),
}
MLA_V = 128
FLASH_CASES.update(MLA_CASES)
#: zamba2-7b's shared attention (32 heads of 112 over 32 kv heads: the mma
#: body pads 112 to its 128 instantiation) and qwen2-vl-72b's (64 q over 8
#: kv heads of 128): each serve run's prefill (batch 8 x 2048 tokens) and a
#: decode step (one query, 1 row a kv head for zamba2 and 8 for qwen2-vl,
#: over a 2080-key cache at ragged fill levels).
SERVE_CASES = {
    "zamba2_prefill": (8, 32, 32, 2048, 2048, 112, True, None, "tokens",
                       PREFILL),
    "zamba2_decode": (8, 32, 32, 1, 2080, 112, True,
                      [1, 2080, 2049, 1500, 777, 64, 65, 2079], "tokens",
                      DECODE),
    "qwen2vl_prefill": (8, 64, 8, 2048, 2048, 128, True, None, "tokens",
                        PREFILL),
    "qwen2vl_decode": (8, 64, 8, 1, 2080, 128, True,
                       [1, 2080, 2049, 1500, 777, 64, 65, 2079], "tokens",
                       DECODE),
}
#: Phase 16e's four archs at their serve shapes, the same way: gemma-2b's
#: 8 q heads over one kv head of 256 (8 rows a kv head in decode),
#: minicpm-2b's 36 heads of 64 (MHA: one row), starcoder2-7b's 36 over 4
#: heads of 128 (a group of 9 rows, odd) and dbrx-132b's 48 over 8 of 128
#: (6 rows).
REGISTRY_HEADS = {"gemma": (8, 1, 256), "minicpm": (36, 36, 64),
                  "starcoder2": (36, 4, 128), "dbrx": (48, 8, 128)}
SERVE_CASES.update({
    f"{name}_{step}": (8, hq, hkv, *shape, d, True, lens, "tokens", bodies)
    for name, (hq, hkv, d) in REGISTRY_HEADS.items()
    for step, shape, lens, bodies in (
        ("prefill", (2048, 2048), None, PREFILL),
        ("decode", (1, 2080), [1, 2080, 2049, 1500, 777, 64, 65, 2079],
         DECODE))})
FLASH_CASES.update(SERVE_CASES)
#: whisper-large-v3's five calls at its serve shapes (phase 16d: batch 8,
#: 1,500 frames, a 750-token prompt, 32 new tokens; 20 heads of 64 over 20
#: kv heads): the encoder's non-causal self-attention, the decoder's causal
#: prefill, the cross-attention's non-causal prefill (750 queries over the
#: 1,500 encoder keys), a decode step's causal self-attention over a cache
#: of up to 782 keys (ragged fill levels) and its non-causal
#: cross-attention over all 1,500 keys (4 splits of 384). 1,500 is not a
#: multiple of the 64-key tiles.
WHISPER_CASES = {
    "whisper_encoder": (8, 20, 20, 1500, 1500, 64, False, None, "tokens",
                        PREFILL),
    "whisper_prefill": (8, 20, 20, 750, 750, 64, True, None, "tokens",
                        PREFILL),
    "whisper_cross_prefill": (8, 20, 20, 750, 1500, 64, False, None,
                              "tokens", PREFILL),
    "whisper_decode": (8, 20, 20, 1, 782, 64, True,
                       [751, 782, 760, 1, 64, 65, 400, 781], "tokens", DECODE),
    "whisper_cross_decode": (8, 20, 20, 1, 1500, 64, False, None, "tokens",
                             DECODE),
}
FLASH_CASES.update(WHISPER_CASES)
#: Tolerances against the plain version: in float32 the two differ only in
#: the order of f32 sums; bfloat16 is the reference's kernel-test tolerance
#: (tests/test_kernels.py:135). Each holds twice: as rtol = atol, and per
#: output row (one (b, t, h) over D) as |got - want| <= tol * (|want| +
#: the row's RMS), which a row averaging over ~1000 keys (RMS ~ 0.03) would
#: fail if a key tile went missing.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: Timed shapes (bfloat16, the serve path's type): name -> case.
FLASH_TIMED = {"prefill": "qwen2_prefill", "decode": "qwen2_decode",
               "mla_prefill": "deepseek_prefill",
               **{case: case for case in (*SERVE_CASES, *WHISPER_CASES)}}
#: The timed shapes where the ``simt`` body is timed in float32 too (the
#: kernels line keeps its time there; a profiled run costs ~1 s).
FLASH_TIMED_F32 = ("prefill", "mla_prefill")
#: The decode timing reads a full cache: kv_len = Tkv for every row (at most
#: 2080).
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
    """q, k, v of a case, drawn on the card (an MLA case's v zero past its
    ``MLA_V`` columns)."""
    b, hq, hkv, tq, tkv, d = FLASH_CASES[case][:6]
    g = torch.Generator("cuda").manual_seed(seed)
    q, k, v = [torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((b, tq, hq, d), (b, tkv, hkv, d), (b, tkv, hkv, d))]
    if case in MLA_CASES:
        v[..., MLA_V:] = 0
    return q, k, v


def flash_scale(case):
    """The scale a case's caller passes: MLA's ``192 ** -0.5``, else the
    default."""
    return FLASH_CASES[case][5] ** -0.5 if case in MLA_CASES else None


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
    the body each case must take. Returns the largest error over the cases,
    that of each body and that of each case."""
    worst, by_body, by_case = 0.0, {}, {}
    for i, (case, (b, hq, hkv, tq, tkv, d, causal, kv_len, layout, bodies)) \
            in enumerate(FLASH_CASES.items()):
        for dtype, body in zip((torch.float32, torch.bfloat16), bodies):
            q, k, v = flash_inputs(torch, case, dtype, seed=i)
            scale = flash_scale(case)
            want = fa.attention_plain(q, k, v, causal=causal, scale=scale,
                                      kv_len=kv_len)
            fa.reset_launches()
            if layout == "heads":       # the Pallas kernel's [B, H, T, D]
                heads = [x.transpose(1, 2).contiguous() for x in (q, k, v)]
                got = fa.flash_attention(*heads, causal=causal,
                                         kv_len=kv_len).transpose(1, 2)
            else:
                got = fa.attention(q, k, v, causal=causal, scale=scale,
                                   kv_len=kv_len)
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
            if case in MLA_CASES and (got[..., MLA_V:] != 0).any():
                raise AssertionError(f"{case}: v's zero columns came out "
                                     f"non-zero")
            if fa.launches != body_launches(body):
                raise AssertionError(f"{case} {dtype}: launches "
                                     f"{fa.launches}, want the {body} body")
            worst = max(worst, err)
            key = f"{body}_{str(dtype)[6:]}"
            by_body[key] = max(by_body.get(key, 0.0), err)
            by_case[case] = max(by_case.get(case, 0.0), err)
    print(f"flash_attention max abs error by body: {by_body}", flush=True)
    return worst, by_body, by_case


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


def kernel_us(torch, fn, n, names, warmup=True):
    """Device us per launch of each kernel of ``names`` that ``fn``
    launches, from ``torch.profiler`` over ``n`` calls (averaged over the
    launches the profiler recorded, which may be fewer than ``n``, or none),
    after one call unprofiled unless ``warmup`` is false."""
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def one_kernel_ms(torch, fn, name, n, warmup=True, tries=3):
    """Device ms per launch of the kernel ``name``, which each call of ``fn``
    launches once: from the profiler (:func:`kernel_us`), profiled again
    where a run recorded no launch of it (a profiled run of one long call
    has come back without its kernel), and after ``tries`` such runs from
    CUDA events around ``n`` calls (the whole call, so a little more than
    the kernel), which the output says."""
    for t in range(tries):
        got = kernel_us(torch, fn, n, (name,), warmup=warmup and t == 0)
        if name in got:
            return got[name] / 1e3
        print(f"the profiler recorded no {name} launch (run {t + 1} of "
              f"{tries})", flush=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / n
    print(f"{name}: {ms:.3f} ms a call, from CUDA events", flush=True)
    return ms


#: The kernels each body of the flash kernel launches, as the profiler names
#: them.
BODY_KERNELS = {"mma": ("mma_kernel",), "simt": ("simt_kernel",),
                "split": ("split_kernel", "combine_kernel")}


def body_kernel_us(torch, fn, body, n=20):
    """Device us per launch of each kernel of the flash body ``body`` that
    ``fn`` launches (:func:`kernel_us`); a kernel the profiled run did not
    record is read again by :func:`one_kernel_ms` (profiled again, else CUDA
    events around the whole call, which it says), so no body reads 0."""
    names = BODY_KERNELS[body]
    got = kernel_us(torch, fn, n, names)
    for name in names:
        if name not in got:
            print(f"the profiler recorded no {name} launch; reading it again",
                  flush=True)
            got[name] = one_kernel_ms(torch, fn, name, n, warmup=False) * 1e3
    return got


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
    body kernel's device us from the profiler; at the qwen2-0.5b and MLA
    prefill shapes (``FLASH_TIMED_F32``) also in float32, where the plan
    takes the simt body."""
    import torch.nn.functional as F

    out = {}
    for label, case in FLASH_TIMED.items():
        b, hq, hkv, tq, tkv, d, causal = FLASH_CASES[case][:7]
        big = tq > 1
        kv_len = tkv if big else min(tkv, DECODE_TIMED_KV_LEN)
        lens = [kv_len] * b
        scale = flash_scale(case)
        q, k, v = flash_inputs(torch, case, torch.bfloat16, seed=99)
        (qh, kh, vh), mask = sdpa_inputs(torch, q, k, v, causal, lens)
        pl = fa.plan(b, tq, tkv, hq, hkv, d, q.dtype, lens)
        kernel = lambda: fa.attention(q, k, v, causal=causal, scale=scale,
                                      kv_len=kv_len)
        plain = lambda: fa.attention_plain(q, k, v, causal=causal,
                                           scale=scale, kv_len=kv_len)
        sdpa = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask, enable_gqa=True, scale=scale)
        # The same function at these inputs without a mask tensor: causal
        # from the top left is the ends-aligned mask when Tq = Tkv = kv_len,
        # and a non-causal call or a single query row over a full cache
        # needs no mask.
        sdpa_fast = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal and tq == tkv, enable_gqa=True,
            scale=scale)
        reps = 20 if big else 100
        n = dict(
            ms=device_ms(torch, kernel, reps=reps, rounds=5),
            library_ms=device_ms(torch, sdpa, reps=reps, rounds=5),
            library_fast_ms=device_ms(torch, sdpa_fast, reps=reps, rounds=5),
            plain_ms=call_ms(torch, plain, reps=3 if big else 20, warmup=1),
            call_ms=call_ms(torch, kernel, reps=20 if big else 100),
            host_ms=host_ms(torch, kernel),
            body=pl.body, plan=list(pl),
            kernels_us=body_kernel_us(torch, kernel, pl.body))
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
        if label in FLASH_TIMED_F32:
            q32, k32, v32 = (x.float() for x in (q, k, v))
            f32_plan = fa.plan(b, tq, tkv, hq, hkv, d, q32.dtype, lens)
            n["f32_plan"] = list(f32_plan)
            n["f32_kernels_us"] = body_kernel_us(torch, lambda: fa.attention(
                q32, k32, v32, causal=causal, scale=scale, kv_len=kv_len),
                f32_plan.body, n=5)
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
    from repro_torch.configs import get_config

    used, prefill, decode, _, _, _ = counted_serve(
        torch, fa, SERVE_ARGS, {"flash_attention": SERVE_LAUNCHES,
                                **SERVE_BODIES},
        get_config("qwen2-0.5b").vocab_size)
    return (used["flash_attention"], {k: used[k] for k in SERVE_BODIES},
            prefill, decode)


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
    with torch.no_grad():       # the scoring forward, through the kernel
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


def golden_top(np, lg, g, arch):
    """The card's f32 logits [steps, B, V] against an f32 golden: the
    values at the golden's top-32 indices and the logsumexp at GOLDEN_TOL;
    an index may differ from the golden's only where the golden's own
    values at the two ranks lie within 2 x tol (a near-tie; the golden
    keeps 40 ranks for that). Returns the largest error."""
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
    print(f"golden {arch} f32 full width vs the reference (CPU, f32): "
          f"top-{k} values max abs error {err:.3e}, logsumexp {lse_err:.3e} "
          f"(tol {GOLDEN_TOL}), top-{k} indices equal but for {swaps} "
          f"near-tie swaps (the golden's smallest neighbour gap "
          f"{float(g['min_gap']):.3e})", flush=True)
    np.testing.assert_allclose(at, gold_val[..., :k], rtol=GOLDEN_TOL,
                               atol=GOLDEN_TOL)
    np.testing.assert_allclose(lse, g["lse"], rtol=GOLDEN_TOL, atol=GOLDEN_TOL)
    return max(err, lse_err)


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


def free_card(torch):
    """Let the card's caching allocator give back what earlier phases'
    models held."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def flash_calls(pl, n):
    """The launch counts of ``n`` calls that take plan ``pl``."""
    return {k: n * v for k, v in body_launches(pl.body).items()}


def mla_prefill_plan(fa, cfg, b, t, dtype):
    """The flash plan of one MLA prefill layer of ``cfg`` (q, k and v at
    the qk head width, one kv head a q head)."""
    m = cfg.mla
    return fa.plan(b, t, t, cfg.num_heads, cfg.num_heads,
                   m.nope_head_dim + m.rope_head_dim, dtype)


def counted_serve(torch, fa, args, want, vocab):
    """``serve.main(args)`` once with 2 new tokens as a warm-up, then
    counted: the flash launches must equal ``want`` and the tokens lie in
    ``[0, vocab)``. Prints ``serve.main``'s lines and a summary; returns
    (the launches, prefill tok/s, decode tok/s, peak GiB, those lines, the
    counted run's wall in seconds)."""
    import contextlib
    import io
    import re

    from repro_torch.launch import serve

    free_card(torch)
    with contextlib.redirect_stdout(io.StringIO()):
        serve.main(args[:-1] + ["2"])
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    fa.reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        seq = serve.main(args)
    wall = time.perf_counter() - t
    used = dict(fa.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    text = buf.getvalue()
    print(text.rstrip(), flush=True)
    rates = [float(x.replace(",", "")) for x in
             re.findall(r"\(([\d,]+) tok/s\)", text)]
    print(f"serve {' '.join(args)}: wall {wall:.2f} s (weights drawn on the "
          f"card included), peak device memory {peak:.2f} GiB, "
          f"flash_attention launches {used} (want {want})", flush=True)
    if used != want:
        raise AssertionError(f"serve {' '.join(args)} launched {used}, want "
                             f"{want}")
    b, gen = int(args[args.index("--batch") + 1]), int(args[-1])
    if seq.shape != (b, gen) or not ((seq >= 0) & (seq < vocab)).all():
        raise AssertionError(f"serve returned tokens {seq.shape} out of range")
    if len(rates) != 2:
        raise AssertionError(f"serve printed no rates: {text!r}")
    return used, rates[0], rates[1], peak, text, wall


def serve_deepseek(torch, np, fa):
    """``serve.main`` for deepseek-v2-lite-16b at full width and depth in
    bf16 (batch 8 x 2048, 32 new tokens), after a warm-up run of 2 new
    tokens. The flash kernel must be called once a layer in the prefill,
    on the body ``plan`` gives, and never in decode. Returns (launches,
    prefill tok/s, decode tok/s, the prefill's moe_dropped, peak GiB)."""
    import re

    from repro_torch.configs import get_config

    cfg = get_config(DEEPSEEK)
    b, p = int(DEEPSEEK_SERVE_ARGS[3]), int(DEEPSEEK_SERVE_ARGS[5])
    want = flash_calls(mla_prefill_plan(fa, cfg, b, p,
                                            cfg.torch_dtype), cfg.num_layers)
    used, prefill, decode, peak, text, _ = counted_serve(
        torch, fa, DEEPSEEK_SERVE_ARGS, want, cfg.vocab_size)
    dropped = [int(x) for x in re.findall(r"prefill moe_dropped: (\d+)", text)]
    print(f"serve {DEEPSEEK}: prefill moe_dropped {dropped}; flash_attention "
          f"one a layer in the prefill, none in decode", flush=True)
    if len(dropped) != 1:
        raise AssertionError(f"serve printed no drops: {text!r}")
    return used, prefill, decode, dropped[0], peak


#: The slice's new serve runs (phase 16c): arch -> extra ``serve.main``
#: arguments. qwen2-vl-72b's 80 layers take ~144 GB in bf16, so it runs at
#: full width cut to its first 16 (~33 GB).
NEW_SERVES = {"mamba2-130m": [], "zamba2-7b": [],
              "qwen2-vl-72b": ["--layers", "16"]}
#: Phase 16e: the four registry archs not served on the card before, the
#: same way. dbrx-132b's 40 layers take ~265 GB in bf16 (16 experts of 3 x
#: 6144 x 10752 a layer, 6.3 GB), so it runs at full width cut to its
#: first 8 (~56 GB).
REGISTRY_SERVES = {"gemma-2b": [], "minicpm-2b": [], "starcoder2-7b": [],
                   "dbrx-132b": ["--layers", "8"]}
NEW_SERVE_ARGS = ["--batch", "8", "--prompt-len", "2048", "--gen", "32"]


def new_serve_want(fa, cfg, b, p, gen):
    """The flash launches a serve run of ``cfg`` must make: one call an
    attention layer (zamba2's shared-block applications; none for mamba2)
    in the prefill and in each of the ``gen - 1`` decode steps, each on the
    body ``plan`` gives."""
    want = {k: 0 for k in body_launches("mma")}
    n = sum(cfg.block_kind(i) in ("attn", "moe", "shared_attn")
            for i in range(cfg.num_layers))
    if not n:
        return want
    h, hkv, d, dt = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.torch_dtype
    for part in (flash_calls(fa.plan(b, p, p, h, hkv, d, dt), n),
                 flash_calls(fa.plan(b, 1, p + gen, h, hkv, d, dt,
                                     [p + 1] * b), n * (gen - 1))):
        for k, v in part.items():
            want[k] += v
    return want


def serve_new(torch, np, fa, serves=NEW_SERVES):
    """``serve.main`` for each arch of ``serves`` at full width (and the
    depth its arguments keep), bf16, batch 8 x 2048, 32 new tokens, each
    after a warm-up run of 2 new tokens: by default mamba2-130m and
    zamba2-7b at full depth and qwen2-vl-72b at depth 16 (from stub patch
    embeddings). The flash kernel must launch exactly as
    :func:`new_serve_want` says (mamba2: never). Returns, by arch, the
    launches by body, prefill and decode tok/s, peak GiB, the prefill's
    ``moe_dropped`` and the counted run's wall."""
    import re

    from repro_torch.configs import get_config

    out = {}
    b, p, gen = (int(x) for x in NEW_SERVE_ARGS[1::2])
    for arch, extra in serves.items():
        cfg = get_config(arch)
        if extra:
            cfg = dataclasses.replace(cfg, num_layers=int(extra[1]))
        want = new_serve_want(fa, cfg, b, p, gen)
        print(f"serve {arch} ({cfg.num_layers} layers): flash launches "
              f"expected {want}", flush=True)
        used, prefill, decode, peak, text, wall = counted_serve(
            torch, fa, ["--arch", arch, *extra, *NEW_SERVE_ARGS], want,
            cfg.vocab_size)
        dropped = [int(x) for x in
                   re.findall(r"prefill moe_dropped: (\d+)", text)]
        if len(dropped) != 1:
            raise AssertionError(f"serve printed no drops: {text!r}")
        print(f"serve {arch}: prefill moe_dropped {dropped[0]}", flush=True)
        out[arch] = dict(launches=used, prefill_tok_s=prefill,
                         decode_tok_s=decode, peak_gib=peak,
                         layers=cfg.num_layers, moe_dropped=dropped[0],
                         wall_s=wall)
    return out


FIXTURES = ROOT / "tests" / "fixtures"
#: The SSM goldens (phase 18d): arch -> fixture.
SSM_GOLDENS = {"mamba2-130m": FIXTURES / "mamba2_130m_golden.npz",
               "zamba2-7b": FIXTURES / "zamba2_7b_golden.npz"}
#: The registry goldens (phase 18h): gemma-2b at depth 4, minicpm-2b at 8
#: and starcoder2-7b at 2 (~965, ~772 and ~887 M values, each within 8 GB
#: on the reference's CPU).
REGISTRY_GOLDENS = {"gemma-2b": FIXTURES / "gemma_2b_golden.npz",
                    "minicpm-2b": FIXTURES / "minicpm_2b_golden.npz",
                    "starcoder2-7b": FIXTURES / "starcoder2_7b_golden.npz"}
#: The two archs held only to themselves before (phase 18h too): qwen2-vl-72b
#: at depth 2 (~4.25 B values) and dbrx-132b at depth 1 (~4.49 B, with its
#: MoE layer's prefill routing). Their weights (~35 GB in f32, with the
#: other goldens' trees more than half the host's memory) are drawn into
#: the card leaf by leaf, no tree on the host (``recipe_model``,
#: ``BIG_DRAW_THREADS`` threads), while phases 4 to 5b run.
BIG_GOLDENS = {"qwen2-vl-72b": FIXTURES / "qwen2_vl_72b_golden.npz",
               "dbrx-132b": FIXTURES / "dbrx_132b_golden.npz"}
BIG_DRAW_THREADS = 4
#: The bf16 goldens (phase 18j): every registry arch's, each made by the JAX
#: package in bfloat16 with its f32 twin's depth, seed and tokens, from the
#: recipe's weights rounded to bf16 as the port rounds them.
BF16_GOLDENS = {
    "qwen2-0.5b": GOLDEN_BF16,
    DEEPSEEK: FIXTURES / "deepseek_v2_lite_golden_bf16.npz",
    "mamba2-130m": FIXTURES / "mamba2_130m_golden_bf16.npz",
    "zamba2-7b": FIXTURES / "zamba2_7b_golden_bf16.npz",
    "whisper-large-v3": FIXTURES / "whisper_large_v3_golden_bf16.npz",
    "gemma-2b": FIXTURES / "gemma_2b_golden_bf16.npz",
    "minicpm-2b": FIXTURES / "minicpm_2b_golden_bf16.npz",
    "starcoder2-7b": FIXTURES / "starcoder2_7b_golden_bf16.npz",
    "qwen2-vl-72b": FIXTURES / "qwen2_vl_72b_golden_bf16.npz",
    "dbrx-132b": FIXTURES / "dbrx_132b_golden_bf16.npz"}
#: Each arch's bf16 tolerance, as a share of |golden| + the row's RMS (phase
#: 18b's measure, GOLDEN_BF16_TOL), between the clean port's reading on the
#: card and its reading with one fault injected: the causal mask dropped in
#: the first attention layer's prefill; where the first layer is a Mamba2
#: layer (mamba2-130m, zamba2-7b) its D skip dropped; where it is a MoE
#: layer (dbrx-132b) expert 0 zeroed. On an H100 (80GB HBM3, 700 W) clean
#: 0.0058-0.0127 and fault 0.111-1.194 for every arch but mamba2, 2e-2
#: between (PERF.md, PR 30).
GOLDEN_BF16_TOLS = {arch: GOLDEN_BF16_TOL for arch in BF16_GOLDENS}
#: mamba2-130m's clean reading, 0.0266 (24 SSM layers over 300 tokens), is
#: above 2e-2; its fault reads 1.134.
GOLDEN_BF16_TOLS["mamba2-130m"] = 4e-2
#: The largest move of a router probability at the golden's top-k (where
#: the experts agree) that a bf16 run may show, in the prefill and in each
#: decode step. The two packages' bf16 MoE inputs differ by bf16 roundings,
#: which moved one by up to 2.1e-3 on the CPU and 5.2e-3 on the card
#: (deepseek-v2-lite's prefill; dbrx-132b 3.4e-3; PERF.md, PR 30).
ROUTE_MOVE_BF16 = 7.5e-3
#: A bf16 routing difference from the golden passes only at a near-tie of
#: the golden's router probabilities (or criticality keys) within this:
#: two probabilities that each move by up to ROUTE_MOVE_BF16 can cross
#: from a gap of twice it, and no further.
ROUTE_TIE_BF16 = 2 * ROUTE_MOVE_BF16


def golden_config(arch, layers=None):
    """``arch``'s full config in float32, cut to ``layers`` where given."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=layers or cfg.num_layers,
                               dtype="float32")


def recipe_tree(trees, arch, cfg, seed):
    """The numpy recipe's weights of ``cfg`` from ``seed`` (float32): the
    tree :func:`golden_weights` drew for ``arch``, taken out of ``trees``,
    or drawn now where there is none."""
    from repro_torch.convert import numpy_lm_params

    tree = (trees or {}).pop(arch, None)
    return numpy_lm_params(cfg, seed) if tree is None else tree


def golden_weights(np, goldens):
    """The numpy recipe's weights of each golden of ``goldens`` (its arch
    at its depth and seed, float32), drawn on the host: arch -> tree. The
    goldens are drawn at once, each on 8 threads (a golden's largest leaf,
    gemma-2b's 524 M-value embedding, takes one thread ~10 s); this runs in
    a thread beside phase 14 (``DRAWN_GOLDENS``: ~6.7 B values, ~27 GB)."""
    with ThreadPoolExecutor(len(goldens)) as pool:
        jobs = {arch: pool.submit(golden_tree, np, arch, path)
                for arch, path in goldens.items()}
    return {arch: job.result() for arch, job in jobs.items()}


def golden_depth(np, path):
    """A golden's depth (``None``: its config's) and seed."""
    with np.load(path) as g:
        return (int(g["layers"]) if "layers" in g.files else None,
                int(g["seed"]))


def golden_tree(np, arch, path):
    """The numpy recipe's f32 weights of the golden at ``path`` (its arch
    at its depth and seed)."""
    from repro_torch.convert import numpy_lm_params

    layers, seed = golden_depth(np, path)
    return numpy_lm_params(golden_config(arch, layers), seed)


def recipe_model(torch, np, arch, path):
    """The f32 model of the golden at ``path`` (its arch at its depth and
    seed) drawn straight into the card (``convert.lm_params_from_recipe``,
    BIG_DRAW_THREADS leaves at a time, no tree on the host), its copies on
    a CUDA stream of its own so that the phases beside it wait for none of
    them. Returns (the model, its seconds)."""
    from repro_torch.convert import lm_params_from_recipe

    t = time.perf_counter()
    layers, seed = golden_depth(np, path)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        model = lm_params_from_recipe(golden_config(arch, layers), seed,
                                      device="cuda", threads=BIG_DRAW_THREADS)
    stream.synchronize()
    return model, time.perf_counter() - t


def against_goldens(torch, np, fa, goldens=SSM_GOLDENS, trees=None,
                    bf16=None, ties=None, launches=None, models=None):
    """Each arch of ``goldens`` at full width and its fixture's depth, f32
    with TF32 off, the numpy recipe's weights (from ``trees``, arch -> the
    tree :func:`golden_weights` drew, which is emptied as it is used; drawn
    here where an arch is missing): a prefill of 2 x 300 tokens and three
    teacher-forced decode steps against the JAX package's golden
    (``golden_top``: top-32 logits and logsumexp at 1e-4), and the flash
    launches :func:`golden_want` gives for them (the prefill on ``simt``,
    every decode step on ``split``; none for mamba2). A MoE arch's prefill
    routing must be the golden's but for near-ties (``routing_check`` at
    ROUTE_TIE; the counts go to ``ties[arch]``; the launches go to
    ``launches[arch]`` where it is given). With ``bf16`` (a dict),
    each arch's bf16 golden (:func:`golden_bf16`) is checked right after
    its f32 one from the same weights (:func:`then_bf16`). ``models`` (arch
    -> a future of :func:`recipe_model`) gives an arch's f32 model already
    on the card, taken out as it is used. By default the SSM goldens:
    mamba2-130m at full depth (past one SSD chunk of 256) and zamba2-7b at
    depth 7 (6 Mamba2 layers, one shared-block application). Returns the
    largest f32 error by arch."""
    from repro_torch.convert import lm_params_from_numpy

    errs = {}
    for arch, path in goldens.items():
        free_card(torch)
        g = np.load(path)
        full_width_f32(torch)
        cfg = golden_config(arch, golden_depth(np, path)[0])
        t = time.perf_counter()
        if models and arch in models:
            model, drawn_s = models.pop(arch).result()
            print(f"golden {arch}: drawn into the card beside earlier phases "
                  f"in {drawn_s:.1f} s, waited {time.perf_counter() - t:.1f} "
                  f"s", flush=True)
        else:
            model = lm_params_from_numpy(
                cfg, recipe_tree(trees, arch, cfg, int(g["seed"])),
                device="cuda")
            print(f"golden {arch}: numpy weights (seed {int(g['seed'])}, "
                  f"{cfg.num_layers} layers) to the card in "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
        tokens = torch.from_numpy(g["tokens"]).cuda()
        prompt = int(g["prompt_len"])
        routes = []
        hooks = prefill_route_hooks(np, model, cfg, prompt, routes)
        fa.reset_launches()
        try:
            lg = teacher_forced(torch, model, cfg, tokens, prompt)
        finally:
            for hook in hooks:
                hook.remove()
        want = golden_want(fa, cfg, tokens.shape[0], prompt,
                           tokens.shape[1] - prompt + 1)
        if fa.launches != want:
            raise AssertionError(f"{arch}: launches {fa.launches}, want {want}")
        errs[arch] = golden_top(np, lg.cpu().numpy(), g, arch)
        print(f"golden {arch}: flash launches {dict(fa.launches)}", flush=True)
        if launches is not None:
            launches[arch] = dict(fa.launches)
        if cfg.moe is not None:
            ties[arch] = golden_routes(np, routes, g, cfg, ROUTE_TIE,
                                       arch)[0]
        then_bf16(torch, np, fa, arch, model, bf16)
        del model
    return errs


def then_bf16(torch, np, fa, arch, model, bf16):
    """Phase 18j for ``arch`` right after its f32 golden, where ``bf16`` is
    a dict: :func:`golden_bf16` from ``model`` (the f32 model on the card,
    the numpy tree's weights), its result and seconds stored in
    ``bf16[arch]``."""
    if bf16 is None:
        return
    t = time.perf_counter()
    bf16[arch] = golden_bf16(torch, np, fa, arch, model)
    bf16[arch]["seconds"] = time.perf_counter() - t
    print(f"golden {arch} bf16 (phase 18j): {bf16[arch]['seconds']:.1f} s",
          flush=True)


def prefill_route_hooks(np, model, cfg, prompt, routes, steps=None):
    """Forward pre-hooks on each MoE module of ``model`` that append the
    routing of each prefill call (``route_record`` of ``moe.route`` on the
    module's input) to ``routes``, and that of each decode step's call to
    ``steps`` where it is given (layer after layer, step after step); none
    in a model without MoE layers."""
    from repro_torch.models import moe

    def record(mod, args):
        x = args[0]
        out = (routes if x.shape[1] == prompt       # the prefill's call
               else steps if x.shape[1] == 1 else None)
        if out is not None:
            out.append(route_record(np, moe.route(mod.router.w, cfg, x), cfg))

    return [blk.ffn.register_forward_pre_hook(record)
            for blk in model.blocks if blk.kind == "moe"]


def route_move(np, got, idx, prob, k):
    """The largest move of a router probability at the golden's top-``k``
    over the tokens whose top-k experts are the golden's, in order: the
    routes ``got`` (:func:`route_record`, a layer each) against the
    golden's expert ids ``idx`` and probabilities ``prob`` of each layer."""
    moved = 0.0
    for (topi, probs, _, _), gi, gp in zip(got, idx, prob, strict=True):
        same = (topi == gi).all(-1)
        if same.any():
            moved = max(moved, float(np.abs(
                probs[..., :k] - gp[..., :k])[same].max()))
    return moved


def rerouted_rows(np, routes, steps, g, cfg, tie):
    """A bf16 run's routing against its golden's, layer by layer: each
    decode step's (``step_route_*``) every difference a near-tie within
    ``tie`` (``routing_check``; the prefill's is :func:`golden_routes`'s).
    Returns (a [steps + 1, B] mask of the logit rows whose token took other
    experts or another keep flag in some MoE layer, in the prefill or the
    step, where the golden's logits are another expert mix's; the decode
    steps' top-k and keep near-ties; their largest move of a router
    probability, :func:`route_move`)."""
    k, p = cfg.moe.top_k, int(g["prompt_len"])
    b, n = g["tokens"].shape[0], g["step_route_idx"].shape[0]
    layers = len(g["route_idx"])
    if len(routes) != layers or len(steps) != n * layers:
        raise AssertionError(f"{len(routes)} prefill and {len(steps)} decode "
                             f"MoE routes recorded, want {layers} and "
                             f"{n * layers}")
    ties, moved = [0, 0], 0.0
    rows = np.zeros((n + 1, b), bool)
    for (topi, _, keep, _), gi, gk in zip(routes, g["route_idx"],
                                          g["route_keep"]):
        last = slice((p - 1) * k, p * k)            # the last token's flags
        rerouted = np.sort(topi[:, -1], -1) != np.sort(gi[:, -1], -1)
        rows[0] |= rerouted.any(-1) | (keep[:, last] != gk[:, last]).any(-1)
    for i in range(n):
        step = {name: g[f"step_{name}"][i] for name in (
            "route_idx", "route_prob", "route_keep", "route_cut_gap")}
        got = steps[i * layers:(i + 1) * layers]
        more = routing_check(np, [(t, keep) for t, _, keep, _ in got], step,
                             tie)
        ties = [a + c for a, c in zip(ties, more)]
        moved = max(moved, route_move(np, got, step["route_idx"],
                                      step["route_prob"], k))
        for (topi, _, _, _), gi in zip(got, step["route_idx"]):
            rows[i + 1] |= (np.sort(topi[:, 0], -1)
                            != np.sort(gi[:, 0], -1)).any(-1)
    return rows, ties, moved


def golden_routes(np, routes, g, cfg, tie, arch):
    """The recorded prefill routing against the golden's (``routing_check``
    within ``tie``): prints the near-ties, the drops beside the golden's
    and the largest difference of a router probability at the golden's
    top-k where the experts agree (:func:`route_move`). Returns ([top-k
    near-ties, keep near-ties], that move)."""
    if len(routes) != len(g["route_idx"]):
        raise AssertionError(f"{arch}: {len(routes)} MoE prefill routes "
                             f"recorded, the golden has {len(g['route_idx'])}")
    idx_ties, keep_ties = routing_check(
        np, [(topi, keep) for topi, _, keep, _ in routes], g, tie)
    k = cfg.moe.top_k
    moved = route_move(np, routes, g["route_idx"], g["route_prob"], k)
    dropped = sum(int((~keep).sum()) for _, _, keep, _ in routes)
    print(f"golden {arch} routing: top-{k} experts and keep masks of "
          f"{len(routes)} MoE layer(s) equal to the golden's but for "
          f"{idx_ties} top-k and {keep_ties} keep near-ties (gap < {tie}); "
          f"dropped {dropped}, the golden {int(g['moe_dropped'])}; router "
          f"probabilities at the golden's top-{k} moved by up to "
          f"{moved:.3e}", flush=True)
    return [idx_ties, keep_ties], moved


def golden_want(fa, cfg, b, p, gen):
    """The flash launches of a golden's prefill of ``p`` tokens and ``gen
    - 1`` teacher-forced decode steps, each call on the body ``plan`` gives
    for ``cfg``'s dtype: an MLA model's prefill layers (none in decode),
    whisper's serve calls over 2p frames (``whisper_serve_want``), any
    other arch's as :func:`new_serve_want` counts them."""
    if cfg.mla is not None:
        return flash_calls(mla_prefill_plan(fa, cfg, b, p, cfg.torch_dtype),
                           cfg.num_layers)
    if cfg.encdec is not None:
        return whisper_serve_want(fa, cfg, b, p, gen)
    return new_serve_want(fa, cfg, b, p, gen)


def bf16_errors(np, lg, g, rows=None):
    """The card's bf16 logits [steps, B, V] (as f32) against a bf16 golden,
    per row as shares of |golden| + the row's RMS over the vocabulary: at
    the golden's top-32 indices, its own top-32 values in order, and its
    logsumexp (a softmax-weighted mean of the logits, against the RMS);
    over the rows of the mask ``rows`` [steps, B] (default: all). Returns
    (those errors, the ranks holding the golden's index, the largest plain
    error at the golden's top-32)."""
    k = int(g["topk"])
    rows = np.ones(lg.shape[:2], bool) if rows is None else rows
    lg, rms, lse_g = lg[rows], g["rms"][rows], g["lse"][rows]
    gold_idx, gold_val = g["top_idx"][rows][..., :k], g["top_val"][rows][..., :k]
    scale = np.abs(gold_val) + rms[..., None]
    at = np.take_along_axis(lg, gold_idx, -1)
    mine = -np.sort(-lg, -1)[..., :k]
    m = lg.max(-1)
    lse = m + np.log(np.exp(lg - m[..., None]).sum(-1))
    errs = {"at the golden's top-32": float((np.abs(at - gold_val) / scale).max()),
            "own top-32 values": float((np.abs(mine - gold_val) / scale).max()),
            "logsumexp": float((np.abs(lse - lse_g) / rms).max())}
    same = int((np.argsort(-lg, -1, kind="stable")[..., :k] == gold_idx).sum())
    return errs, same, float(np.abs(at - gold_val).max())


def golden_bf16(torch, np, fa, arch, f32_model):
    """Phase 18j for ``arch``: its full config in bfloat16 (the serve
    path's dtype) at its bf16 golden's depth, the numpy recipe's weights
    (those of ``f32_model``, the f32 model on the card) rounded to bf16 as
    they are copied into the model, a prefill on the serve path's bodies (``mma``;
    MLA's too) and three teacher-forced decode steps (``split`` +
    ``combine``), whisper's through ``whisper_steps`` from the golden's
    frames; the launches must be those ``plan`` gives (:func:`golden_want`).
    The scaled errors (:func:`bf16_errors`) must stay within the arch's
    GOLDEN_BF16_TOLS; a MoE arch's routing (the prefill's and each decode
    step's) must be the golden's but for near-ties within ROUTE_TIE_BF16,
    and a logit row whose token took other experts (another mix than the
    golden's) is counted and left out (:func:`rerouted_rows`). Returns the
    errors, the worst, the tolerance, the launches, the near-ties and the
    largest moves of a router probability (prefill, decode steps)."""
    from repro_torch.configs import get_config

    free_card(torch)
    g = np.load(BF16_GOLDENS[arch])
    base = get_config(arch)
    layers = int(g["layers"]) if "layers" in g.files else base.num_layers
    cfg = dataclasses.replace(base, num_layers=layers)
    if cfg.dtype != str(g["dtype"]):
        raise AssertionError(f"config dtype {cfg.dtype}, golden {g['dtype']}")
    t = time.perf_counter()
    model = bf16_twin(torch, f32_model, cfg)
    load_s = time.perf_counter() - t
    prompt = int(g["prompt_len"])
    routes, step_routes = [], []
    hooks = prefill_route_hooks(np, model, cfg, prompt, routes, step_routes)
    fa.reset_launches()
    try:
        if cfg.encdec is not None:
            frames, tokens = whisper_inputs(torch, np, g, cfg)
            lg = whisper_steps(torch, model, cfg, frames, tokens, prompt)
        else:
            tokens = torch.from_numpy(g["tokens"]).cuda()
            lg = teacher_forced(torch, model, cfg, tokens, prompt)
    finally:
        for hook in hooks:
            hook.remove()
    used = dict(fa.launches)
    b, steps = tokens.shape[0], tokens.shape[1] - prompt
    want = golden_want(fa, cfg, b, prompt, steps + 1)
    if used != want or want["flash_attention_simt"]:
        raise AssertionError(f"{arch}: launches {used}, want {want} (no simt)")
    rows, ties, moves = None, None, None
    if cfg.moe is not None:
        ties, moved = golden_routes(np, routes, g, cfg, ROUTE_TIE_BF16, arch)
        rerouted, step_ties, step_moved = rerouted_rows(
            np, routes, step_routes, g, cfg, ROUTE_TIE_BF16)
        ties = [a + c for a, c in zip(ties, step_ties)]
        moves = [moved, step_moved]
        rows = ~rerouted
        print(f"golden {arch} bf16 routing: prefill and {steps} decode steps"
              f" equal to the golden's but for {ties[0]} top-k and {ties[1]} "
              f"keep near-ties (gap < {ROUTE_TIE_BF16}); {int(rerouted.sum())}"
              f" of {rerouted.size} logit rows took other experts at their "
              f"token and are left out; router probabilities moved by up to "
              f"{moved:.3e} (prefill) and {step_moved:.3e} (decode steps), "
              f"bound {ROUTE_MOVE_BF16}", flush=True)
        if not rows.any():
            raise AssertionError(f"{arch}: every row took other experts")
        if not max(moves) <= ROUTE_MOVE_BF16:
            raise AssertionError(f"{arch}: a router probability moved by "
                                 f"{max(moves)}, bound {ROUTE_MOVE_BF16}")
    errs, same, abs_err = bf16_errors(np, lg.float().cpu().numpy(), g, rows)
    worst, tol = max(errs.values()), GOLDEN_BF16_TOLS[arch]
    k = int(g["topk"])
    print(f"golden {arch} bf16 full width, {layers} layers"
          f" vs the reference (CPU, bf16), "
          f"weights in {load_s:.1f} s, prefill of {prompt} and "
          f"{steps} decode steps: scaled errors "
          f"{ {n: round(e, 5) for n, e in errs.items()} } (tol {tol} x "
          f"(|golden| + row RMS)); max abs error at the golden's top-{k} "
          f"{abs_err:.3e} (row RMS {float(g['rms'].min()):.3f}-"
          f"{float(g['rms'].max()):.3f}); {same} top-{k} ranks hold the "
          f"golden's index; flash launches {used}", flush=True)
    del model
    if not worst <= tol:
        raise AssertionError(f"{arch}: bf16 logits off the reference's "
                             f"golden: {errs}, tol {tol}")
    return dict(scaled_err=errs, worst=worst, tol=tol, launches=used,
                route_near_ties=ties, route_moves=moves)


def bf16_twin(torch, src, cfg):
    """A model of ``cfg`` on the card holding the weights of ``src`` (the
    f32 model of the same arch and depth), each copied into its
    parameter's dtype: bf16 rounded to nearest even, as
    ``lm_params_from_numpy`` rounds a leaf, the router and SSM scalars
    kept f32. Frozen, as every model of the port."""
    from repro_torch.models import lm

    model = lm.LM(cfg, device="cuda")
    weights = dict(src.named_parameters())
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return model


#: qwen2-vl-72b at full width in f32 (TF32 off): layers, batch, prompt
#: embeddings, teacher-forced decode steps: prefill + decode from stub
#: embeddings against ``forward``, at CONSIST_TOL (its golden, from tokens,
#: is phase 18h's).
VLM_CONSIST = (2, 2, 64, 8)


def vlm_consistency(torch, np, fa):
    """qwen2-vl-72b at full width, depth 2, f32: ``forward`` over p + n
    stub embeddings, where embedding p + i is the token-i row of the
    embedding table, gives at each position the logits of a prefill of
    the first p embeddings followed by teacher-forced decode steps of those
    tokens (the prefill of t + 1 embeddings equals the prefill of t and one
    decode step), at CONSIST_TOL. The prefill runs on ``simt`` (f32), each
    decode step on ``split``. Returns the largest error."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    free_card(torch)
    layers, b, p, n = VLM_CONSIST
    full_width_f32(torch)
    cfg = dataclasses.replace(get_config("qwen2-vl-72b"), num_layers=layers,
                              dtype="float32")
    g = torch.Generator("cuda").manual_seed(0)
    model = lm.init(g, cfg)
    emb = torch.randn((b, p, cfg.d_model), generator=g, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (b, n), generator=g,
                         device="cuda", dtype=torch.int32)
    seq = torch.cat([emb, model.embed[toks]], dim=1)         # [b, p + n, d]
    with torch.no_grad():       # the scoring forward, through the kernel
        h, _ = lm.forward(model, cfg, embeds=seq)
    full = lm.logits_fn(model, cfg, h)[:, p - 1:-1].transpose(0, 1)
    cache = lm.init_cache(cfg, b, p + n, device="cuda")
    fa.reset_launches()
    logits, cache = lm.prefill(model, cfg, embeds=emb, cache=cache)
    steps = [logits]
    for i in range(n - 1):
        logits, cache = lm.decode_step(model, cfg, toks[:, i], cache, p + i)
        steps.append(logits)
    kern = torch.stack(steps)
    want = {k: 0 for k in body_launches("mma")}
    want.update({"flash_attention": layers * n, "flash_attention_simt": layers,
                 "flash_attention_split": layers * (n - 1),
                 "flash_attention_combine": layers * (n - 1)})
    err = (kern - full).abs().max().item()
    print(f"consistency qwen2-vl-72b f32 full width, {layers} layers, batch "
          f"{b}, {p} prompt embeddings, {n - 1} decode steps: prefill+decode "
          f"vs forward max abs error {err:.3e} (tol {CONSIST_TOL}; |logits| "
          f"up to {full[..., :cfg.vocab_size].abs().max().item():.3f}); "
          f"launches {dict(fa.launches)}", flush=True)
    if fa.launches != want:
        raise AssertionError(f"launches {fa.launches}, want {want}")
    torch.testing.assert_close(kern, full, rtol=CONSIST_TOL, atol=CONSIST_TOL)
    return err


def deepseek_f32(torch, layers, **moe):
    """deepseek-v2-lite-16b's full width in float32 cut to ``layers``, its
    MoE config replaced by ``moe``; TF32 off (``full_width_f32``)."""
    from repro_torch.configs import get_config

    full_width_f32(torch)
    cfg = get_config(DEEPSEEK)
    return dataclasses.replace(cfg, num_layers=layers, dtype="float32",
                               moe=dataclasses.replace(cfg.moe, **moe))


def routing_check(np, got, g, tie=ROUTE_TIE):
    """Each MoE layer's prefill routing against the golden's: a top-k id
    may differ only at a near-tie of the golden's router probabilities
    (neighbouring ranks within ``tie``), a keep flag only where the
    golden's criticality keys on either side of that expert's cut lie
    within ``tie`` or the expert took part in such a top-k near-tie.
    Returns (top-k near-ties, keep near-ties)."""
    idx_ties = keep_ties = 0
    for layer, (topi, keep) in enumerate(got):
        gi, gp = g["route_idx"][layer], g["route_prob"][layer]
        gk, gap = g["route_keep"][layer], g["route_cut_gap"][layer]
        excused = set()
        for pos in zip(*np.nonzero(topi != gi)):
            grp, tok, r = pos
            gaps = [abs(gp[grp, tok, r] - gp[grp, tok, r + 1])]
            if r > 0:
                gaps.append(abs(gp[grp, tok, r - 1] - gp[grp, tok, r]))
            if not min(gaps) < tie:
                raise AssertionError(
                    f"routing: layer {layer} group {grp} token {tok} rank {r}"
                    f": expert {topi[pos]}, the golden's {gi[pos]}, gaps "
                    f"{gaps} (no near-tie)")
            excused |= {(grp, int(topi[pos])), (grp, int(gi[pos]))}
            idx_ties += 1
        fe = gi.reshape(gi.shape[0], -1)
        for grp, j in zip(*np.nonzero(keep != gk)):
            e = int(fe[grp, j])
            if not ((grp, e) in excused or gap[grp, e] < tie):
                raise AssertionError(
                    f"routing: layer {layer} group {grp} assignment {j} "
                    f"(expert {e}) kept {keep[grp, j]}, the golden "
                    f"{gk[grp, j]}; the golden's gap at the cut {gap[grp, e]}")
            keep_ties += 1
    return idx_ties, keep_ties


def deepseek_consistency(torch, np, fa):
    """deepseek-v2-lite at full width, depth 4, f32, capacity factor 8 (no
    drops): prefill + 16 teacher-forced decode steps equal ``forward``'s
    logits at CONSIST_TOL; the flash kernel runs once a layer in the
    prefill, never in decode."""
    from repro_torch.models import lm

    free_card(torch)
    layers, cf = DEEPSEEK_CONSIST
    cfg = deepseek_f32(torch, layers, capacity_factor=cf)
    model = lm.init(torch.Generator("cuda").manual_seed(0), cfg)
    b, p, n = CONSIST
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p + n))
                              .astype(np.int32)).cuda()
    with torch.no_grad():       # the scoring forward, through the kernel
        h, metrics = lm.forward(model, cfg, tokens=tokens)
    full = lm.logits_fn(model, cfg, h)[:, p - 1:].transpose(0, 1)
    cache = lm.init_cache(cfg, b, p + n, device="cuda")
    fa.reset_launches()
    logits, cache, pm = lm.prefill(model, cfg, tokens=tokens[:, :p],
                                   cache=cache, return_metrics=True)
    steps = [logits]
    for i in range(p, p + n):
        logits, cache = lm.decode_step(model, cfg, tokens[:, i], cache, i)
        steps.append(logits)
    kern = torch.stack(steps)
    want = flash_calls(mla_prefill_plan(fa, cfg, b, p,
                                            torch.float32), layers)
    drops = (int(metrics["moe_dropped"].item()), int(pm["moe_dropped"].item()))
    e_full = (kern - full).abs().max().item()
    print(f"consistency {DEEPSEEK} f32 full width, {layers} layers, capacity "
          f"factor {cf}, batch {b}, prompt {p}, {n} decode steps: prefill+"
          f"decode vs forward max abs error {e_full:.3e} (tol {CONSIST_TOL}; "
          f"|logits| up to {full[..., :cfg.vocab_size].abs().max().item():.3f})"
          f"; moe_dropped forward / prefill {drops}; launches "
          f"{dict(fa.launches)}", flush=True)
    if fa.launches != want:
        raise AssertionError(f"launches {fa.launches}, want {want}")
    if drops != (0, 0):
        raise AssertionError(f"capacity factor {cf} dropped {drops}")
    torch.testing.assert_close(kern, full, rtol=CONSIST_TOL, atol=CONSIST_TOL)
    return e_full


DBRX = "dbrx-132b"
#: dbrx-132b's f32 consistency (phase 18i): layers and capacity factor. At
#: E / top_k = 4 an expert's slots a group equal the group's tokens, so
#: nothing drops and ``forward`` over the whole sequence equals the prefill
#: and decode steps (the reference's serving test does the same). 2 layers
#: at full width are ~7.8 B f32 values (~31 GB on the card); the
#: reference's golden (phase 18h) is at depth 1.
DBRX_CONSIST = (2, 4.0)


def route_record(np, r, cfg):
    """One MoE layer's routing from ``moe.route``'s dict ``r``, on the host,
    in the golden's layout (``routing_check``): the top-k expert ids, the
    k + 1 largest router probabilities, the capacity cut's keep mask and,
    per (group, expert), the gap between the criticality keys on either
    side of the cut (inf where the expert took no more than its
    capacity)."""
    k, e, cap = cfg.moe.top_k, cfg.moe.num_experts, r["cap"]
    probs = r["probs"].sort(-1, descending=True).values[..., :k + 1]
    fe = r["topi"].reshape(r["topi"].shape[0], -1)
    key = (fe.float() * 2.0 + (1.0 - r["topw"].reshape(fe.shape))).cpu().numpy()
    fe = fe.cpu().numpy()
    gap = np.full((fe.shape[0], e), np.inf, np.float32)
    for gi in range(fe.shape[0]):
        for ei in range(e):
            ks = np.sort(key[gi][fe[gi] == ei])
            if len(ks) > cap:
                gap[gi, ei] = ks[cap] - ks[cap - 1]
    return (r["topi"].cpu().numpy(), probs.cpu().numpy(),
            (r["mypos"] < cap).cpu().numpy(), gap)


def dbrx_consistency(torch, np, fa):
    """dbrx-132b at full width, depth 2, f32 (TF32 off), weights from a card
    generator, capacity factor 4 (no drops): prefill and 16 teacher-forced
    decode steps through the kernel against ``forward``'s logits and
    against the same steps with the plain attention, at CONSIST_TOL; each
    MoE layer's prefill routing (top-4 ids and keep mask, read by a hook
    through ``moe.route``) in the kernel's run equal to the plain run's
    but for near-ties (``routing_check``, the plain run standing for the
    golden); the flash launches as :func:`new_serve_want` gives them (the
    prefill on ``simt``, each decode step on ``split``). Returns (the
    largest logit error, top-4 near-ties, keep near-ties)."""
    from unittest import mock

    from repro_torch.configs import get_config
    from repro_torch.models import lm

    free_card(torch)
    layers, cf = DBRX_CONSIST
    full_width_f32(torch)
    cfg = get_config(DBRX)
    cfg = dataclasses.replace(cfg, num_layers=layers, dtype="float32",
                              moe=dataclasses.replace(cfg.moe,
                                                      capacity_factor=cf))
    t = time.perf_counter()
    model = lm.init(torch.Generator("cuda").manual_seed(0), cfg)
    torch.cuda.synchronize()
    print(f"consistency {DBRX}: {layers} layers of f32 weights drawn on the "
          f"card in {time.perf_counter() - t:.1f} s", flush=True)
    b, p, n = CONSIST
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p + n))
                              .astype(np.int32)).cuda()
    with torch.no_grad():       # the scoring forward, through the kernel
        h, metrics = lm.forward(model, cfg, tokens=tokens)
    full = lm.logits_fn(model, cfg, h)[:, p - 1:].transpose(0, 1)
    runs = {}
    for name, attn in (("kernel", fa.attention), ("plain", fa.attention_plain)):
        routes = []
        hooks = prefill_route_hooks(np, model, cfg, p, routes)
        fa.reset_launches()
        try:
            with mock.patch.object(fa, "attention", attn):
                lg = teacher_forced(torch, model, cfg, tokens, p)
        finally:
            for hook in hooks:
                hook.remove()
        runs[name] = (lg, routes, dict(fa.launches))
    (kern, got, used), (plain, ref, _) = runs["kernel"], runs["plain"]
    want = new_serve_want(fa, cfg, b, p, n + 1)
    if used != want:
        raise AssertionError(f"launches {used}, want {want}")
    g = {name: np.stack([r[i] for r in ref]) for i, name in enumerate(
        ("route_idx", "route_prob", "route_keep", "route_cut_gap"))}
    idx_ties, keep_ties = routing_check(
        np, [(topi, keep) for topi, _, keep, _ in got], g)
    drops = (int(metrics["moe_dropped"].item()),
             sum(int((~keep).sum()) for _, _, keep, _ in got))
    e_full = (kern - full).abs().max().item()
    e_plain = (kern - plain).abs().max().item()
    print(f"consistency {DBRX} f32 full width, {layers} layers, capacity "
          f"factor {cf}, batch {b}, prompt {p}, {n} decode steps: prefill+"
          f"decode vs forward max abs error {e_full:.3e}, vs the plain "
          f"attention on the card {e_plain:.3e} (tol {CONSIST_TOL}; |logits| "
          f"up to {full[..., :cfg.vocab_size].abs().max().item():.3f}); "
          f"moe_dropped forward / prefill {drops}; top-{cfg.moe.top_k} "
          f"experts and keep masks of {len(got)} MoE layers equal to the "
          f"plain run's but for {idx_ties} top-k and {keep_ties} keep "
          f"near-ties (gap < {ROUTE_TIE}); launches {used}", flush=True)
    if drops != (0, 0):
        raise AssertionError(f"capacity factor {cf} dropped {drops}")
    if len(got) != layers or len(ref) != layers:
        raise AssertionError(f"{len(got)} and {len(ref)} MoE prefill routes "
                             f"recorded")
    torch.testing.assert_close(kern, full, rtol=CONSIST_TOL, atol=CONSIST_TOL)
    torch.testing.assert_close(kern, plain, rtol=CONSIST_TOL, atol=CONSIST_TOL)
    del model
    free_card(torch)
    return max(e_full, e_plain), idx_ties, keep_ties


def deepseek_profiles(torch, fa):
    """``torch.profiler`` over one deepseek-v2-lite prefill of phase 16b's
    shape (bf16, batch 8 x 2048) and over 4 decode steps after it; no flash
    launch in the decode steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    free_card(torch)
    cfg = get_config(DEEPSEEK)
    g = torch.Generator("cuda").manual_seed(0)
    model = lm.init(g, cfg)
    b, p, n = 8, 2048, 4
    tokens = torch.randint(0, cfg.vocab_size, (b, p), generator=g,
                           device="cuda", dtype=torch.int32)
    cache = lm.init_cache(cfg, b, p + n, device="cuda")
    cur = tokens[:, -1].contiguous()

    def decode():
        for i in range(n):
            lm.decode_step(model, cfg, cur, cache, p + i)

    profile_run(torch, lambda: lm.prefill(model, cfg, tokens=tokens,
                                          cache=cache),
                1, f"serve {DEEPSEEK} bf16 prefill batch {b} x {p}", "prefill")
    fa.reset_launches()
    profile_run(torch, decode, n, f"serve {DEEPSEEK} bf16 decode batch {b} at "
                f"cache length {p}", "step")
    if fa.launches["flash_attention"]:
        raise AssertionError(f"deepseek decode launched {fa.launches}")


def zamba2_profiles(torch, fa):
    """``torch.profiler`` over one zamba2-7b prefill of phase 16c's shape
    (bf16, batch 8 x 2048, full depth) and over 4 decode steps after it:
    where the hybrid's time goes (the SSD scan's torch ops, the GEMMs, the
    11 shared-block applications through kernel 5)."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    free_card(torch)
    cfg = get_config("zamba2-7b")
    g = torch.Generator("cuda").manual_seed(0)
    model = lm.init(g, cfg)
    b, p, n = 8, 2048, 4
    tokens = torch.randint(0, cfg.vocab_size, (b, p), generator=g,
                           device="cuda", dtype=torch.int32)
    cache = lm.init_cache(cfg, b, p + n, device="cuda")
    cur = tokens[:, -1].contiguous()

    def decode():
        for i in range(n):
            lm.decode_step(model, cfg, cur, cache, p + i)

    profile_run(torch, lambda: lm.prefill(model, cfg, tokens=tokens,
                                          cache=cache),
                1, f"serve zamba2-7b bf16 prefill batch {b} x {p}", "prefill")
    profile_run(torch, decode, n, f"serve zamba2-7b bf16 decode batch {b} at "
                f"cache length {p}", "step")


#: whisper-large-v3 at full width and depth (32 encoder and 32 decoder
#: layers, 1.54 B parameters), served as the reference's serve serves it:
#: frames [8, 2 x 750, 1280], a 750-token decoder prompt, 32 new tokens.
WHISPER = "whisper-large-v3"
WHISPER_SERVE_ARGS = ["--arch", WHISPER, "--batch", "8", "--prompt-len",
                      "750", "--gen", "32"]
#: Its kernel 5 launches by body: the prefill's 32 encoder, 32 causal
#: self-attention and 32 cross-attention calls on ``mma``; each of the 31
#: decode steps' 32 self- and 32 cross-attention calls on ``split`` with its
#: ``combine``.
WHISPER_SERVE_BODIES = {"flash_attention": 96 + 2 * 32 * 31,
                        "flash_attention_mma": 96,
                        "flash_attention_split": 2 * 32 * 31,
                        "flash_attention_combine": 2 * 32 * 31,
                        "flash_attention_simt": 0}
WHISPER_GOLDEN = ROOT / "tests" / "fixtures" / "whisper_large_v3_golden.npz"
#: Sampled decoding on the card (phase 18g): qwen2-0.5b at full width in
#: bf16, batch, prompt, sampled decode steps, temperature, key seed.
SAMPLED = (8, 64, 8, 0.8, 11)


def whisper_serve_want(fa, cfg, b, p, gen):
    """The flash launches of a whisper serve run, each call on the body
    ``plan`` gives: in the prefill one an encoder layer (non-causal over
    the 2p frames) and two a decoder layer (causal self-attention over the
    p prompt tokens; cross-attention of the p tokens over the 2p frames);
    in each of the ``gen - 1`` decode steps two a decoder layer
    (self-attention over the cache, cross-attention over the 2p frames)."""
    h, hkv, d, dt = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.torch_dtype
    n, te = cfg.num_layers, 2 * p
    calls = [(fa.plan(b, te, te, h, hkv, d, dt), cfg.encdec.enc_layers),
             (fa.plan(b, p, p, h, hkv, d, dt), n),
             (fa.plan(b, p, te, h, hkv, d, dt), n)]
    for i in range(gen - 1):
        calls += [(fa.plan(b, 1, p + gen, h, hkv, d, dt, [p + i + 1] * b), n),
                  (fa.plan(b, 1, te, h, hkv, d, dt), n)]
    want = {k: 0 for k in body_launches("mma")}
    for pl, count in calls:
        for k, v in flash_calls(pl, count).items():
            want[k] += v
    return want


def serve_whisper(torch, np, fa):
    """``serve.main`` for whisper-large-v3 at full width and depth in bf16
    (batch 8, 1,500 frames, a 750-token prompt, 32 new tokens), after a
    warm-up run of 2 new tokens. The flash kernel must launch as
    :func:`whisper_serve_want` says, which must be WHISPER_SERVE_BODIES
    (printed first). Returns the launches, prefill and decode tok/s and peak
    GiB."""
    from repro_torch.configs import get_config

    cfg = get_config(WHISPER)
    b, p, gen = (int(x) for x in WHISPER_SERVE_ARGS[3::2])
    want = whisper_serve_want(fa, cfg, b, p, gen)
    print(f"serve {WHISPER} ({cfg.encdec.enc_layers} + {cfg.num_layers} "
          f"layers, {2 * p} frames, prompt {p}): flash launches expected "
          f"{want}", flush=True)
    if want != WHISPER_SERVE_BODIES:
        raise AssertionError(f"plan gives {want}, want {WHISPER_SERVE_BODIES}")
    used, prefill, decode, peak, _, _ = counted_serve(
        torch, fa, WHISPER_SERVE_ARGS, want, cfg.vocab_size)
    return dict(launches=used, prefill_tok_s=prefill, decode_tok_s=decode,
                peak_gib=peak, layers=[cfg.encdec.enc_layers, cfg.num_layers])


def whisper_inputs(torch, np, g, cfg):
    """The golden's frames and tokens on the card, drawn again from its
    seed as its script draws them (frames first); their sum and the tokens
    must be the golden's."""
    rng = np.random.default_rng(int(g["seed"]))
    b = g["tokens"].shape[0]
    frames = rng.standard_normal((b, int(g["frames_len"]), cfg.d_model),
                                 dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab_size, g["tokens"].shape).astype(np.int32)
    if (frames.sum(dtype=np.float64) != float(g["frames_sum"])
            or not (tokens == g["tokens"]).all()):
        raise AssertionError("the golden's inputs do not come out of its seed")
    return torch.from_numpy(frames).cuda(), torch.from_numpy(tokens).cuda()


def whisper_steps(torch, model, cfg, frames, tokens, prompt):
    """Logits of an encdec prefill over ``frames`` and ``tokens[:,
    :prompt]`` and of a decode step for each later token: [steps, B, V]."""
    from repro_torch.models import lm

    b, t = tokens.shape
    cache = lm.encdec_init_cache(cfg, b, t, frames.shape[1], device="cuda")
    logits, cache = lm.prefill_encdec(model, cfg, frames, tokens[:, :prompt],
                                      cache)
    steps = [logits]
    for i in range(prompt, t):
        logits, cache = lm.decode_step_encdec(model, cfg, tokens[:, i], cache,
                                              i)
        steps.append(logits)
    return torch.stack(steps)


def whisper_golden(torch, np, fa, trees=None, bf16=None):
    """whisper-large-v3 at full width and depth in f32 (TF32 off), the numpy
    recipe's weights (~6.1 GB): the encoder over 2 x 150 frames, a prefill
    of 75 tokens and three teacher-forced decode steps against the JAX
    package's golden (``golden_top``: top-32 logits and logsumexp at 1e-4),
    the f32 prefill's calls on ``simt`` (150 and 75 rows a kv head) and the
    steps' on ``split``. Then the same model's prefill of 32 tokens and 16
    teacher-forced decode steps against ``forward_encdec``'s logits at
    CONSIST_TOL; then phase 18j's whisper where ``bf16`` is a dict
    (:func:`then_bf16`). Returns (the golden's largest error, the
    consistency's)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import lm

    free_card(torch)
    g = np.load(WHISPER_GOLDEN)
    full_width_f32(torch)
    cfg = dataclasses.replace(get_config(WHISPER), dtype="float32")
    if int(g["layers"]) != cfg.num_layers:
        raise AssertionError(f"golden of {int(g['layers'])} layers")
    t = time.perf_counter()
    model = lm_params_from_numpy(
        cfg, recipe_tree(trees, WHISPER, cfg, int(g["seed"])), device="cuda")
    print(f"golden {WHISPER}: numpy weights (seed {int(g['seed'])}, "
          f"{cfg.encdec.enc_layers} + {cfg.num_layers} layers) to the card in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    frames, tokens = whisper_inputs(torch, np, g, cfg)
    fa.reset_launches()
    lg = whisper_steps(torch, model, cfg, frames, tokens, int(g["prompt_len"]))
    n_dec = tokens.shape[1] - int(g["prompt_len"])
    want = {"flash_attention": 96 + 64 * n_dec, "flash_attention_simt": 96,
            "flash_attention_mma": 0, "flash_attention_split": 64 * n_dec,
            "flash_attention_combine": 64 * n_dec}
    if fa.launches != want:
        raise AssertionError(f"launches {fa.launches}, want {want}")
    err = golden_top(np, lg.cpu().numpy(), g, WHISPER)

    b, p, n = CONSIST
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.standard_normal(
        (b, int(g["frames_len"]), cfg.d_model), dtype=np.float32)).cuda()
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, p + n))
                              .astype(np.int32)).cuda()
    with torch.no_grad():       # the scoring forward, through the kernel
        h, _ = lm.forward_encdec(model, cfg, frames, tokens)
    full = lm.logits_fn(model, cfg, h)[:, p - 1:].transpose(0, 1)
    fa.reset_launches()
    kern = whisper_steps(torch, model, cfg, frames, tokens, p)
    e_full = (kern - full).abs().max().item()
    print(f"consistency {WHISPER} f32 full width and depth, batch {b}, "
          f"{frames.shape[1]} frames, prompt {p}, {n} decode steps: prefill+"
          f"decode vs forward_encdec max abs error {e_full:.3e} (tol "
          f"{CONSIST_TOL}; |logits| up to "
          f"{full[..., :cfg.vocab_size].abs().max().item():.3f}); launches "
          f"{dict(fa.launches)}", flush=True)
    torch.testing.assert_close(kern, full, rtol=CONSIST_TOL, atol=CONSIST_TOL)
    then_bf16(torch, np, fa, WHISPER, model, bf16)
    del model
    return err, e_full


def sampled_decoding(torch, np, fa):
    """Sampled decode steps of qwen2-0.5b at full width in bf16 (SAMPLED:
    batch 8, a 64-token prompt, 8 steps at temperature 0.8), the key of
    step i ``fold_in(key(11), i)``: each step's 32-bit draws in the
    partitionable layout on the card equal the same draw on the CPU bit for
    bit, and so do its uniforms; each sampled token equals
    ``argmax(logits / T + gumbel)`` computed on the CPU from the card's
    logits. Returns (the steps' smallest top-two margin on the CPU, host ms
    a sampled step, host ms a greedy step)."""
    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.models import lm
    from repro_torch.train.steps import make_decode_step

    free_card(torch)
    b, p, n, temp, seed = SAMPLED
    cfg = get_config("qwen2-0.5b")
    g = torch.Generator("cuda").manual_seed(0)
    model = lm.init(g, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (b, p), generator=g,
                           device="cuda", dtype=torch.int32)
    cache = lm.init_cache(cfg, b, p + 2 * n, device="cuda")
    logits, cache = lm.prefill(model, cfg, tokens=tokens, cache=cache)
    cur = torch.argmax(logits, -1).to(torch.int32)
    step = make_decode_step(cfg, greedy=False, temperature=temp)
    greedy = make_decode_step(cfg)
    margin, walls = float("inf"), []
    for i in range(n):
        key = prng.fold_in(prng.key(seed), i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        nxt, logits, cache = step(model, cur, cache, p + i, key.cuda())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        shape = tuple(logits.shape)
        for name, draw in (("bits", lambda k: prng.random_bits(
                k, 32, shape, partitionable=True)),
                           ("uniforms", lambda k: prng.uniform(
                               k, shape, prng.F32_TINY, 1.0
                           ).view(torch.int32))):
            if not torch.equal(draw(key.cuda()).cpu(), draw(key)):
                raise AssertionError(f"step {i}: the card's {name} differ "
                                     f"from the CPU's")
        noisy = prng.gumbel(key, shape) + logits.cpu() / temp
        want = torch.argmax(noisy, -1).to(torch.int32)
        top2 = torch.topk(noisy, 2, dim=-1).values
        margin = min(margin, (top2[:, 0] - top2[:, 1]).min().item())
        if not torch.equal(nxt.cpu(), want):
            raise AssertionError(f"step {i}: sampled {nxt.tolist()}, the CPU "
                                 f"{want.tolist()}")
        cur = nxt
    greedy_walls = []
    for i in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cur, _, cache = greedy(model, cur, cache, p + n + i)
        torch.cuda.synchronize()
        greedy_walls.append(time.perf_counter() - t)
    s_ms = statistics.median(walls) * 1e3
    g_ms = statistics.median(greedy_walls) * 1e3
    print(f"sampled decoding qwen2-0.5b bf16 full width, batch {b}, prompt "
          f"{p}, {n} steps at T = {temp}: each step's {b} x "
          f"{cfg.padded_vocab} partitionable Threefry bits and uniforms on "
          f"the card equal the CPU's bit for bit; every token equals the "
          f"CPU's argmax(logits / T + gumbel) (smallest top-two margin "
          f"{margin:.3e}); host {s_ms:.2f} ms a sampled step, {g_ms:.2f} ms a "
          f"greedy one (medians)", flush=True)
    del model
    return margin, s_ms, g_ms


def whisper_profiles(torch, fa):
    """``torch.profiler`` over one whisper-large-v3 prefill of phase 16d's
    shape (bf16, batch 8, 1,500 frames, 750 tokens, full depth: the
    encoder, the decoder prefill and the cross cache) and over 4 decode
    steps after it."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    free_card(torch)
    cfg = get_config(WHISPER)
    g = torch.Generator("cuda").manual_seed(0)
    model = lm.init(g, cfg)
    b, p, n = 8, 750, 4
    frames = torch.randn((b, 2 * p, cfg.d_model), generator=g,
                         device="cuda").to(cfg.torch_dtype)
    tokens = torch.randint(0, cfg.vocab_size, (b, p), generator=g,
                           device="cuda", dtype=torch.int32)
    cache = lm.encdec_init_cache(cfg, b, p + n, 2 * p, device="cuda")
    cur = tokens[:, -1].contiguous()

    def decode():
        for i in range(n):
            lm.decode_step_encdec(model, cfg, cur, cache, p + i)

    profile_run(torch, lambda: lm.prefill_encdec(model, cfg, frames, tokens,
                                                 cache),
                1, f"serve {WHISPER} bf16 prefill batch {b}, {2 * p} frames, "
                f"{p} tokens", "prefill")
    profile_run(torch, decode, n, f"serve {WHISPER} bf16 decode batch {b} at "
                f"cache length {p}", "step")
    del model


def golden_launches(big_launches, bf16):
    """The flash launches of the phases this kernels line adds, by phase
    and body: phase 18h's f32 goldens of qwen2-vl-72b and dbrx-132b (and
    each arch's), and phase 18j's bf16 goldens (summed, and each arch's)."""
    def total(runs):
        out = {}
        for launches in runs.values():
            for k, v in launches.items():
                out[k] = out.get(k, 0) + v
        return dict(total=out, **runs)

    return {"18h qwen2-vl-72b and dbrx-132b f32": total(big_launches),
            "18j bf16": total({arch: r["launches"]
                               for arch, r in bf16.items()})}


def host_memory():
    """The host's MemTotal and this process's peak resident set, GiB."""
    import resource

    with open("/proc/meminfo") as f:
        total = next(int(line.split()[1]) for line in f
                     if line.startswith("MemTotal:"))
    return total / 2**20, resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2**20


def big_goldens(torch, np, fa, models, bf16):
    """Phase 18h for qwen2-vl-72b and dbrx-132b (and their phase 18j): each
    f32 model taken from its job (``models``: arch -> a future of
    :func:`recipe_model`) as it is ready, its f32 golden then its bf16
    golden checked from it (``against_goldens``, dbrx's routing within
    ROUTE_TIE); prints the host's MemTotal and the script's peak RSS.
    Returns (the f32 errors, the routing near-ties, the f32 runs' flash
    launches) by arch."""
    ties, launches = {}, {}
    errs = against_goldens(torch, np, fa, BIG_GOLDENS, None, bf16, ties,
                           launches, models)
    total, peak = host_memory()
    print(f"host memory: MemTotal {total:.1f} GiB, this script's peak RSS "
          f"{peak:.1f} GiB", flush=True)
    return errs, ties, launches


#: The goldens whose numpy weights ``lm_phases`` draws beside phase 14:
#: arch -> fixture (its depth, or the config's where it keeps none, and its
#: seed). qwen2-0.5b's tree serves its f32 and bf16 goldens.
DRAWN_GOLDENS = {"qwen2-0.5b": GOLDEN, DEEPSEEK: DEEPSEEK_GOLDEN,
                 **SSM_GOLDENS, WHISPER: WHISPER_GOLDEN, **REGISTRY_GOLDENS}


def lm_phases(torch, np, bf16, big):
    """The LM serving path: the flash kernel against its plain version, its
    times, serve at full width (qwen2-0.5b, deepseek-v2-lite, mamba2-130m,
    zamba2-7b and qwen2-vl-72b at depth 16, counted), consistency, the
    goldens and the profiles. ``bf16`` holds phase 18j's results so far
    (the big goldens', :func:`big_goldens`, whose results are ``big``) and
    gets the others'. Returns the ``flash_attention`` entry of the kernels
    line."""
    from repro_torch.kernels import flash_attention as fa

    # The goldens' weights are drawn on the host while the kernel checks
    # (untimed) run on the card, and waited for before any timing.
    with ThreadPoolExecutor(1) as pool:
        drawing = pool.submit(golden_weights, np, DRAWN_GOLDENS)
        err, err_by_body, err_by_case = phase("flash_attention check",
                                              check_flash, torch, fa)
        ex2_abs, ex2_rel = phase("flash_attention ex2 error", ex2_error,
                                 torch, fa)
        trees = phase("golden weights (the rest of their draw)",
                      drawing.result)
    total, peak = host_memory()
    print(f"golden weights: {len(trees)} trees drawn; host MemTotal "
          f"{total:.1f} GiB, this script's peak RSS {peak:.1f} GiB",
          flush=True)
    timed = phase("flash_attention time", flash_times, torch, fa)
    launches, bodies, prefill_tps, decode_tps = phase(
        "serve main path", serve_main_path, torch, np, fa)
    ds_launches, ds_prefill, ds_decode, ds_dropped, ds_peak = phase(
        "serve deepseek", serve_deepseek, torch, np, fa)
    phase("serve consistency", consistency, torch, np, fa)
    # Phase 18j: each bf16 golden right after its f32 twin, from the same
    # weights (18b is qwen2-0.5b's), into ``bf16``.
    ds_ties = {}
    phase("serve against the golden", against_goldens, torch, np, fa,
          {"qwen2-0.5b": GOLDEN}, trees, bf16)
    ds_err = phase("deepseek against the golden", against_goldens, torch, np,
                   fa, {DEEPSEEK: DEEPSEEK_GOLDEN}, trees, bf16,
                   ds_ties)[DEEPSEEK]
    ds_idx_ties, ds_keep_ties = ds_ties[DEEPSEEK]
    ds_consist = phase("deepseek consistency", deepseek_consistency, torch,
                       np, fa)
    new_serves = phase("serve mamba2, zamba2, qwen2-vl", serve_new, torch, np,
                       fa)
    new_serves[WHISPER] = phase("serve whisper", serve_whisper, torch, np, fa)
    new_serves.update(phase("serve gemma, minicpm, starcoder2, dbrx",
                            serve_new, torch, np, fa, REGISTRY_SERVES))
    ssm_errs = phase("ssm goldens", against_goldens, torch, np, fa,
                     SSM_GOLDENS, trees, bf16)
    vlm_consist = phase("vlm consistency", vlm_consistency, torch, np, fa)
    whisper_err, whisper_consist = phase("whisper golden", whisper_golden,
                                         torch, np, fa, trees, bf16)
    registry_errs = phase("registry goldens", against_goldens, torch, np, fa,
                          REGISTRY_GOLDENS, trees, bf16)
    if trees:
        raise AssertionError(f"golden trees left unused: {sorted(trees)}")
    dbrx_err, dbrx_idx_ties, dbrx_keep_ties = phase(
        "dbrx consistency", dbrx_consistency, torch, np, fa)
    sample_margin, sampled_ms, greedy_ms = phase(
        "sampled decoding", sampled_decoding, torch, np, fa)
    phase("serve profiles", serve_profiles, torch)
    phase("deepseek profiles", deepseek_profiles, torch, fa)
    phase("zamba2 profiles", zamba2_profiles, torch, fa)
    phase("whisper profiles", whisper_profiles, torch, fa)
    big_errs, big_ties, big_launches = big
    pre, dec, mla = timed["prefill"], timed["decode"], timed["mla_prefill"]
    us = {**pre["kernels_us"], **dec["kernels_us"]}
    timed_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                  "library_fast_ms", "call_ms", "host_ms", "shape", "plan",
                  "kernels_us")
    new_shapes = {case: dict({k: timed[case][k] for k in timed_keys},
                             max_abs_err=err_by_case[case])
                  for case in (*SERVE_CASES, *WHISPER_CASES)}
    new_launches = {arch: r["launches"]["flash_attention"]
                    for arch, r in new_serves.items()}
    return dict(
        name="flash_attention", route="cuda", source=FLASH_SOURCE,
        replaces=FLASH_REPLACES,
        launches=launches + ds_launches["flash_attention"]
        + sum(new_launches.values()),
        serve_launches={"qwen2-0.5b": launches,
                        DEEPSEEK: ds_launches["flash_attention"],
                        **new_launches},
        serve_shapes=new_shapes, serves=new_serves,
        ssm_golden_max_abs_err=ssm_errs,
        registry_golden_max_abs_err=registry_errs,
        dbrx_consistency_max_abs_err=dbrx_err,
        dbrx_route_near_ties=[dbrx_idx_ties, dbrx_keep_ties],
        vlm_consistency_max_abs_err=vlm_consist,
        whisper_golden_max_abs_err=whisper_err,
        whisper_consistency_max_abs_err=whisper_consist,
        sampled=dict(min_top2_margin=sample_margin, step_host_ms=sampled_ms,
                     greedy_step_host_ms=greedy_ms),
        max_abs_err=err,
        ms=pre["ms"], plain_ms=pre["plain_ms"], bound_ms=pre["bound_ms"],
        bound_by=pre["bound_by"], library_ms=pre["library_ms"],
        call_ms=pre["call_ms"], host_ms=pre["host_ms"], shape=pre["shape"],
        dtype="bfloat16",
        decode=dict((k, dec[k]) for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_fast_ms", "call_ms", "host_ms", "shape", "plan")),
        mla_prefill=dict(
            {k: mla[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_fast_ms", "call_ms", "host_ms", "shape", "plan",
                "kernels_us", "f32_plan", "f32_kernels_us")},
            max_abs_err=max(err_by_case[c] for c in MLA_CASES),
            serve_launches=ds_launches, serve_prefill_tok_s=ds_prefill,
            serve_decode_tok_s=ds_decode, serve_prefill_moe_dropped=ds_dropped,
            serve_peak_gib=ds_peak, golden_max_abs_err=ds_err,
            golden_route_near_ties=[ds_idx_ties, ds_keep_ties],
            consistency_max_abs_err=ds_consist),
        library_fast_ms=pre["library_fast_ms"], plan=pre["plan"],
        ex2_max_abs_err=ex2_abs, ex2_max_rel_err=ex2_rel,
        bodies={
            "mma": dict(launches=bodies["flash_attention_mma"]
                        + ds_launches["flash_attention_mma"]
                        + sum(r["launches"]["flash_attention_mma"]
                              for r in new_serves.values()),
                        ms=us.get("mma_kernel", 0.0) / 1e3, at="prefill",
                        max_abs_err=err_by_body.get("mma_bfloat16")),
            "split": dict(launches=bodies["flash_attention_split"]
                          + sum(r["launches"]["flash_attention_split"]
                                for r in new_serves.values()),
                          ms=us.get("split_kernel", 0.0) / 1e3, at="decode",
                          max_abs_err=max(err_by_body.get("split_bfloat16", 0),
                                          err_by_body.get("split_float32", 0))),
            "combine": dict(launches=bodies["flash_attention_combine"]
                            + sum(r["launches"]["flash_attention_combine"]
                                  for r in new_serves.values()),
                            ms=us.get("combine_kernel", 0.0) / 1e3,
                            at="decode"),
            "simt": dict(launches=bodies["flash_attention_simt"],
                         ms=pre["f32_kernels_us"].get("simt_kernel", 0.0) / 1e3,
                         at="prefill (f32)",
                         max_abs_err=err_by_body.get("simt_float32"))},
        serve_prefill_tok_s=prefill_tps, serve_decode_tok_s=decode_tps,
        golden_bf16_scaled_err=bf16["qwen2-0.5b"]["worst"],
        golden_bf16_tol=GOLDEN_BF16_TOLS["qwen2-0.5b"],
        golden_bf16={arch: {k: r[k] for k in (
            "scaled_err", "worst", "tol", "launches", "route_near_ties",
            "route_moves")}
            for arch, r in bf16.items()},
        big_golden_max_abs_err=big_errs, big_golden_route_near_ties=big_ties,
        golden_launches=golden_launches(big_launches, bf16))


# ---------------------------------------------------------------------------
# Training (phases 20-20e): the driver at full width, the JAX golden,
# every family on the card, sharded training on a 1x1 and a 2x2 mesh.
# ---------------------------------------------------------------------------

TRAIN_ARGS = ["--arch", "qwen2-0.5b", "--data", "zipf", "--batch", "8",
              "--seq", "1024", "--steps", "20", "--warmup", "4",
              "--log-every", "5", "--ckpt-every", "20"]
TRAIN_CKPT = ROOT / "build" / "train_ckpt"
#: Phase 20's gate: the mean of the last 5 losses at most this times the
#: first 5's.
TRAIN_FALL = 0.9
TRAIN_GOLDEN = ROOT / "tests" / "fixtures" / "qwen2_0_5b_train_golden.npz"
#: The golden's tolerances (float32, TF32 off): the loss and xent relative;
#: the gradient's global norm relative; each leaf's gradient norm relative;
#: each sliced gradient within ``grad`` of its slice's largest magnitude;
#: each sliced weight after one AdamW step (lr 1e-3, an update of ~lr an
#: element) within ``new`` absolute. Accuracy and the token count exact.
TRAIN_GOLDEN_TOL = dict(loss=1e-5, grad_norm=1e-4, leaf_norm=1e-3, grad=1e-3,
                        new=1e-5)
#: Accumulation against the full batch: the reference test's thresholds
#: (``tests/test_train.py:89``): the loss relative; the parameters after a
#: step of AdamW(lr=1e-3, no master weights), relative and absolute.
TRAIN_ACCUM_TOL = dict(loss=1e-4, rtol=2e-3, atol=2e-5)
TINY_GRAD = 1e-7
#: Every family's smoke config, a step on the card against the same step on
#: the CPU: the loss relative; each gradient leaf within ``grad`` of its
#: largest magnitude plus 1e-7; the parameters after the step (AdamW, lr
#: ``lr``) within ``q_lr`` x lr at 99.9% of each leaf's elements and 2 x lr
#: + 1e-6 everywhere (Adam's update is at most ~lr, and an element whose
#: gradient is zero but for rounding, such as whisper's k bias, may step
#: either way).
TRAIN_FAMILY_TOL = dict(loss=1e-5, grad=1e-4, lr=1e-3, q_lr=1e-2)
#: The crash-and-resume run: the qwen2-0.5b smoke config through the
#: driver, crashed after SIM_FAIL steps.
RESUME_ARGS = ["--arch", "qwen2-0.5b", "--smoke", "--batch", "8", "--seq",
               "64", "--steps", "12", "--warmup", "2", "--log-every", "100",
               "--ckpt-every", "100"]
SIM_FAIL = 5
TRAIN_RESUME_CKPT = ROOT / "build" / "train_resume"
#: Phase 20d: the driver on a 1x1 mesh, phase 20's arguments for this many
#: steps.
TRAIN_1X1_STEPS = 5
TRAIN_1X1_CKPT = ROOT / "build" / "train_1x1"
#: Phase 20e: the global batch and the steps of the 2x2 mesh and its 1x1
#: run, and their WSD schedule (peak, warmup, stable, decay).
TRAIN_2X2 = dict(batch=4, seq=1024, steps=3)
TRAIN_2X2_LR = (3e-3, 4, 12, 4)
#: The learning rates the three updates apply (the schedule's counts 1-3).
TRAIN_2X2_LR_SUM = 3e-3 * (1 + 2 + 3) / 4
#: Phase 20e's tolerances, 2x2 against 1x1 (bf16 parameters: the ranks'
#: GEMMs see 2 of the 4 rows, and cuBLAS may tile them otherwise, so the
#: bf16 activations and gradients round apart): the losses and gradient
#: norms relative; the master weights everywhere within 2 x the summed lr
#: (Adam moves an element at most ~lr a step, either way where a gradient
#: near zero flips its sign), and at most the fraction ``beyond`` of the
#: elements further off than ``q_lr`` x the summed lr.
TRAIN_2X2_TOL = dict(loss=1e-3, grad_norm=1e-2, q_lr=0.1, beyond=1e-2)


def flat_tree(np, tree, prefix=""):
    """A reference-layout tree -> {"a/b/0/c": leaf}."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(flat_tree(np, v, f"{prefix}{k}/"))
    return out


def to_device(torch, batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train_full_width(torch, np, fa):
    """Phase 20: ``repro_torch.launch.train.main`` trains qwen2-0.5b at full
    width and depth (bf16 parameters, f32 master weights, WSD AdamW) on
    ``SyntheticZipfLM`` batches of 8 x 1,024 tokens for 20 steps (warmup
    4), with one async checkpoint at the last step. Every loss finite, the
    mean of the last 5 at most TRAIN_FALL of the first 5's, kernel 5
    launched 0 times (training takes the differentiable form). Prints ms a
    step (steps 3-20, each step's end read by its loss), tok/s, peak device
    memory and the checkpoint's bytes and seconds (the host copy and the
    writer thread, which the driver waits for at its end); then profiles
    one more step (``profile_run``)."""
    import shutil

    from repro_torch.data.pipeline import SyntheticZipfLM
    from repro_torch.launch import train
    from repro_torch.optim import AdamW
    from repro_torch.train.steps import make_train_step

    free_card(torch)
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    fa.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    losses, stamps = [], []

    def on_step(step, state, m):
        losses.append(float(m["loss"]))                 # waits for the step
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    state = train.main(TRAIN_ARGS + ["--ckpt", str(TRAIN_CKPT)],
                       on_step=on_step)
    ckpt_s = time.perf_counter() - stamps[-1]
    launches = fa.launches["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    files = [f for f in TRAIN_CKPT.rglob("*") if f.is_file()]
    ckpt_bytes = sum(f.stat().st_size for f in files)
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    tokens = 8 * 1024
    ms = (stamps[-1] - stamps[1]) / (steps - 2) * 1e3
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    model = state["params"]
    print(f"train qwen2-0.5b full width and depth: {steps} steps of 8 x "
          f"1024 tokens (zipf), bf16 parameters "
          f"({model.embed.dtype}), f32 master weights "
          f"({state['opt']['master']['embed'].dtype}); losses "
          f"{[round(x, 4) for x in losses]}; mean of the first 5 "
          f"{first:.4f}, of the last 5 {last:.4f} (ratio {last / first:.4f},"
          f" gate {TRAIN_FALL}); {ms:.1f} ms a step after 2 "
          f"({tokens / ms * 1e3:,.0f} tok/s); first step "
          f"{(stamps[0] - t0) * 1e3:.1f} ms with the set-up; peak "
          f"{peak:.2f} GiB; kernel 5 launches {launches}; checkpoint at step "
          f"{steps}: {ckpt_bytes:,} bytes in {len(files)} files, "
          f"{ckpt_s:.1f} s", flush=True)
    if len(losses) != steps or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"losses {losses}")
    if last > TRAIN_FALL * first:
        raise AssertionError(f"the loss fell from {first} to {last} only")
    if launches != 0:
        raise AssertionError(f"training launched kernel 5 {launches} times")
    if (model.embed.dtype != torch.bfloat16
            or state["opt"]["master"]["embed"].dtype != torch.float32):
        raise AssertionError("not bf16 parameters with f32 master weights")
    if (TRAIN_CKPT / "LATEST").read_text() != str(steps):
        raise AssertionError("no checkpoint at the last step")
    shutil.rmtree(TRAIN_CKPT)
    # Where a step's time goes: three more steps of the trained state, the
    # last under the profiler.
    step = make_train_step(model.cfg, AdamW(lr=3e-4, weight_decay=0.01))
    batch = to_device(torch, SyntheticZipfLM(
        model.cfg.vocab_size, batch=8, seq=1024, seed=0).batch_at(steps),
        "cuda")
    profile_run(torch, lambda: step(state, batch), 1,
                "train qwen2-0.5b bf16 batch 8 x 1024", "step")
    del state, model
    free_card(torch)
    return dict(losses=losses, ms_per_step=ms, tok_s=tokens / ms * 1e3,
                peak_gib=peak, launches=launches, ckpt_bytes=ckpt_bytes,
                ckpt_s=ckpt_s)


def train_golden(torch, np, device, g, prefix=""):
    """qwen2-0.5b in f32 at the golden's depth (``prefix`` ``""``: full,
    ``"small_"``: 2 layers) with the numpy recipe's weights (their float64
    sums equal the golden's) and its copy-task batch (its tokens equal the
    golden's): the loss, xent, accuracy and token count, the gradient's
    global norm, each leaf's gradient norm, the sliced gradients and the
    sliced weights (equal) and, after one AdamW step (lr ``g["lr"]``), the
    sliced weights, against the JAX package's golden
    (``tests/fixtures/make_qwen2_0_5b_train_golden.py``) at
    TRAIN_GOLDEN_TOL. Returns the largest error of each kind (relative,
    or in units of the tolerance's scale) and the weight tree (numpy, for
    :func:`train_accum`)."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticCopyTask
    from repro_torch.optim import AdamW
    from repro_torch.train.steps import make_loss_fn

    tol = TRAIN_GOLDEN_TOL
    layers = int(g["small_layers" if prefix else "layers"])
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=layers,
                              dtype="float32")
    seed = int(g["seed"])
    tree = convert.numpy_lm_params(cfg, seed)
    weights = flat_tree(np, tree)
    sums = dict(zip(g[prefix + "weight_paths"], g[prefix + "weight_sums"]))
    if {k: x.sum(dtype=np.float64) for k, x in weights.items()} != sums:
        raise AssertionError("the numpy recipe no longer makes the golden's "
                             "weights")
    model = convert.lm_params_from_numpy(cfg, tree, device=device)
    model.requires_grad_(True)
    batch = SyntheticCopyTask(cfg.vocab_size, batch=int(g["batch"]),
                              seq=int(g["seq"]), seed=seed).batch_at(0)
    if not np.array_equal(batch["tokens"], g["batch_tokens"]):
        raise AssertionError("the copy task no longer makes the golden's batch")
    loss, metrics = make_loss_fn(cfg)(model, to_device(torch, batch, device))
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    gtree = flat_tree(np, convert.named_to_numpy(cfg, grads))
    err = {}

    def rel(name, got, want):
        err[name] = max(err.get(name, 0.0),
                        abs(float(got) - float(want)) / abs(float(want)))

    rel("loss", loss.item(), g[prefix + "loss"])
    rel("xent", metrics["xent"].item(), g[prefix + "xent"])
    for k in ("accuracy", "tokens"):
        if metrics[k].item() != float(g[prefix + k]):
            raise AssertionError(f"{k} {metrics[k].item()} != "
                                 f"{float(g[prefix + k])}")
    paths = [str(p) for p in g[prefix + "leaf_paths"]]
    if sorted(gtree) != paths:
        raise AssertionError("the gradient's leaves differ from the golden's")
    for p, want in zip(paths, g[prefix + "leaf_grad_norms"]):
        rel("leaf_norm", np.sqrt(np.square(gtree[p], dtype=np.float64).sum()),
            want)
    for s in (str(x) for x in g["slices"]):
        idx = g[f"{prefix}idx/{s}"]
        want = g[f"{prefix}grad/{s}"]
        err["grad"] = max(err.get("grad", 0.0), float(np.abs(
            gtree[s].reshape(-1)[idx] - want).max() / np.abs(want).max()))
        if not np.array_equal(weights[s].reshape(-1)[idx],
                              g[f"{prefix}param/{s}"]):
            raise AssertionError(f"weights {s} differ from the golden's")
    del gtree, weights
    opt = AdamW(lr=float(g["lr"]))
    _, _, om = opt.update(grads, opt.init(model), model)
    rel("grad_norm", om["grad_norm"].item(), g[prefix + "grad_norm"])
    new = flat_tree(np, convert.lm_params_to_numpy(model))
    for s in (str(x) for x in g["slices"]):
        err["new"] = max(err.get("new", 0.0), float(np.abs(
            new[s].reshape(-1)[g[f"{prefix}idx/{s}"]]
            - g[f"{prefix}new/{s}"]).max()))
    print(f"train golden qwen2-0.5b f32, {layers} layers, on {device}: loss "
          f"{loss.item():.6f} (golden {float(g[prefix + 'loss']):.6f}), "
          f"grad_norm {om['grad_norm'].item():.6f} (golden "
          f"{float(g[prefix + 'grad_norm']):.6f}); largest errors "
          f"{ {k: float(f'{v:.3e}') for k, v in err.items()} } (tolerances "
          f"{tol})", flush=True)
    for k, v in err.items():
        if not v <= tol["loss" if k == "xent" else k]:
            raise AssertionError(f"train golden: {k} error {v:.3e}")
    del model, grads, new
    return err, tree


def train_accum(torch, np, device, tree, layers):
    """One step of qwen2-0.5b in f32 (``layers`` deep, the weights
    ``tree``) on the golden's copy-task batch with ``grad_accum=2`` (two
    microbatches of one row) against the full batch, AdamW(lr=1e-3, no
    master weights) as in the reference test: the loss and the parameters
    at its thresholds (TRAIN_ACCUM_TOL), and the gradient (the first
    moment, ``(1 - b1) g``) within 1e-5 of each leaf's largest magnitude.
    Where the full batch's clipped gradient is below TINY_GRAD, ten times
    AdamW's eps, Adam's step ``g / (|g| + eps)`` turns the gradient's last
    bits into a visible part of ``lr`` (a third of the elements at depth 2:
    the tied embedding's rows that only the head reaches), so the
    parameter check holds those to one step, ``lr + atol``, and the
    gradient check covers them. Returns the loss's relative difference,
    the other parameters' largest ratio of difference to tolerance, the
    count of elements below TINY_GRAD and the moments' largest error."""
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticCopyTask
    from repro_torch.optim import AdamW
    from repro_torch.train.steps import make_train_step

    tol = TRAIN_ACCUM_TOL
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=layers,
                              dtype="float32")
    batch = to_device(torch, SyntheticCopyTask(
        cfg.vocab_size, batch=2, seq=64, seed=0).batch_at(0), device)
    opt = AdamW(lr=1e-3, master_weights=False)
    out = {}
    for ga in (1, 2):
        model = convert.lm_params_from_numpy(cfg, tree, device=device)
        st = {"params": model.requires_grad_(True), "opt": opt.init(model),
              "step": torch.zeros((), dtype=torch.int32, device=device)}
        st, m = make_train_step(cfg, opt, grad_accum=ga)(st, batch)
        out[ga] = (m["loss"].item(), [p.detach() for p in model.parameters()],
                   list(st["opt"]["m"].values()))
        del st, model
    (l1, p1, m1), (l2, p2, m2) = out[1], out[2]
    loss_rel = abs(l2 - l1) / abs(l1)
    ratio, tiny, tiny_err, m_err = 0.0, 0, 0.0, 0.0
    for a, b, ma, mb in zip(p2, p1, m2, m1):
        m_err = max(m_err, ((ma - mb).abs().max()
                            / (mb.abs().max() + 1e-30)).item())
        small = mb.abs() < (1 - opt.b1) * TINY_GRAD
        r = (a - b).abs() / (tol["atol"] + tol["rtol"] * b.abs())
        ratio = max(ratio, torch.where(small, 0.0, r).max().item())
        tiny += int(small.sum())
        tiny_err = max(tiny_err, torch.where(small, (a - b).abs(), 0.0)
                       .max().item())
    print(f"train grad_accum=2 against the full batch, qwen2-0.5b f32, "
          f"{layers} layers, on {device}: loss {l2:.6f} vs {l1:.6f} "
          f"(relative {loss_rel:.3e}, tol {tol['loss']}); gradients (first "
          f"moments) {m_err:.3e} of each leaf's scale (tol 1e-5); "
          f"parameters' largest |difference| / (atol + rtol |p|) "
          f"{ratio:.3e} (at most 1) over the elements with |g| >= "
          f"{TINY_GRAD}; the {tiny:,} below it within {tiny_err:.3e} (lr + "
          f"atol {opt.lr + tol['atol']:.1e})", flush=True)
    if (loss_rel > tol["loss"] or m_err > 1e-5 or ratio > 1
            or tiny_err > opt.lr + tol["atol"]):
        raise AssertionError("grad_accum=2 is not close to the full batch")
    return loss_rel, ratio, tiny, m_err


def against_train_golden(torch, np, fa):
    """Phase 20b: :func:`train_golden` at full width and depth on the card
    (f32, TF32 off), then :func:`train_accum` there; kernel 5 launched 0
    times. Returns the errors."""
    free_card(torch)
    full_width_f32(torch)
    g = np.load(TRAIN_GOLDEN)
    fa.reset_launches()
    t = time.perf_counter()
    err, tree = train_golden(torch, np, "cuda", g)
    print(f"train golden: {time.perf_counter() - t:.1f} s with the numpy "
          f"weights", flush=True)
    free_card(torch)
    loss_rel, ratio, tiny, m_err = train_accum(torch, np, "cuda", tree,
                                               int(g["layers"]))
    if fa.launches["flash_attention"] != 0:
        raise AssertionError("training launched kernel 5")
    del tree
    free_card(torch)
    return dict(golden=err, accum_loss_rel=loss_rel, accum_ratio=ratio,
                accum_tiny_grads=tiny, accum_grad_err=m_err)


def family_batch(np, cfg):
    """The copy task's batch (2 rows, 15 tokens), with stub patch embeddings
    in place of the tokens for a VLM and stub frames (twice the tokens)
    beside them for an encoder-decoder, from ``default_rng(1)``."""
    from repro_torch.data.pipeline import SyntheticCopyTask

    b = SyntheticCopyTask(cfg.vocab_size, batch=2, seq=16, seed=0).batch_at(0)
    t = b["tokens"].shape[1]
    rng = np.random.default_rng(1)
    if cfg.encdec is not None:
        b["frames"] = rng.standard_normal((2, 2 * t, cfg.d_model),
                                          dtype=np.float32)
    elif cfg.family == "vlm":
        b["embeds"] = rng.standard_normal((2, t, cfg.d_model),
                                          dtype=np.float32)
        del b["tokens"]
    return b


def family_step(torch, cfg, tree, batch, device):
    """The loss and gradients of the smoke config ``cfg`` from the weights
    ``tree``, then one train step (AdamW, lr TRAIN_FAMILY_TOL["lr"]) from
    the same state: (loss, {name: grad}, {name: parameter after})."""
    from repro_torch import convert
    from repro_torch.optim import AdamW
    from repro_torch.train.steps import make_loss_fn, make_train_step

    model = convert.lm_params_from_numpy(cfg, tree, device=device)
    model.requires_grad_(True)
    b = to_device(torch, batch, device)
    loss, _ = make_loss_fn(cfg)(model, b)
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a VLM's embedding table takes no gradient from embeds: zeros
    grads = {n: (torch.zeros_like(p) if x is None else x).cpu()
             for n, p, x in zip(names, leaves, grads)}
    opt = AdamW(lr=TRAIN_FAMILY_TOL["lr"])
    st = {"params": model, "opt": opt.init(model),
          "step": torch.zeros((), dtype=torch.int32, device=device)}
    st, m = make_train_step(cfg, opt)(st, b)
    if m["loss"].item() != loss.item():
        raise AssertionError("the train step's loss is not the loss's")
    return loss.item(), grads, {n: p.detach().cpu()
                                for n, p in model.named_parameters()}


def train_families(torch, np, fa):
    """Phase 20c, first part: one train step of every registry arch's smoke
    config in f32 (TF32 off) on the card and on the CPU, from the numpy
    recipe's weights and the same batch: the loss, every gradient and every
    parameter after the step at TRAIN_FAMILY_TOL. This runs the MoE
    dispatch, MLA, the SSD scan, M-RoPE, the hybrid's shared block and
    whisper's encoder and cross-attention under autograd on CUDA. Kernel 5
    is launched 0 times. Returns {arch: (loss error, gradient error,
    parameter error at 99.9%, largest parameter error)}."""
    from repro_torch import convert
    from repro_torch.configs import ARCHS, get_config

    tol = TRAIN_FAMILY_TOL
    full_width_f32(torch)
    fa.reset_launches()
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        tree = convert.numpy_lm_params(cfg, 0)
        batch = family_batch(np, cfg)
        l_cpu, g_cpu, p_cpu = family_step(torch, cfg, tree, batch, "cpu")
        l_gpu, g_gpu, p_gpu = family_step(torch, cfg, tree, batch, "cuda")
        e_loss = abs(l_gpu - l_cpu) / abs(l_cpu)
        e_grad = max(((g_gpu[n] - w).abs().max()
                      / (w.abs().max() + 1e-7 / tol["grad"])).item()
                     for n, w in g_cpu.items())
        diffs = torch.cat([(p_gpu[n] - w).abs().reshape(-1)
                           for n, w in p_cpu.items()])
        e_q = torch.quantile(diffs[:2**24].double(), 0.999).item()
        e_max = diffs.max().item()
        out[arch] = (e_loss, e_grad, e_q, e_max)
        print(f"train {arch} smoke, one step, card against CPU: loss "
              f"{l_gpu:.6f} (relative {e_loss:.2e}), gradients "
              f"{e_grad:.2e} of each leaf's scale, parameters after the "
              f"step {e_q:.2e} at 99.9%, {e_max:.2e} at most (lr "
              f"{tol['lr']})", flush=True)
        if (e_loss > tol["loss"] or e_grad > tol["grad"]
                or e_q > tol["q_lr"] * tol["lr"]
                or e_max > 2 * tol["lr"] + 1e-6):
            raise AssertionError(f"train {arch}: the card and the CPU differ")
    if fa.launches["flash_attention"] != 0:
        raise AssertionError("training launched kernel 5")
    return out


def train_resume(torch, np):
    """Phase 20c, second part: the driver on the qwen2-0.5b smoke config on
    the card (RESUME_ARGS), uninterrupted; then with ``--sim-fail
    SIM_FAIL`` (a checkpoint, then a crash); the checkpoint restored must
    equal the state at that step bit for bit; then restarted, it resumes
    and its final parameters must equal the uninterrupted run's bit for
    bit. Returns the number of parameters that differ (0)."""
    import shutil

    from repro_torch import convert
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train

    shutil.rmtree(TRAIN_RESUME_CKPT, ignore_errors=True)
    want = train.main(RESUME_ARGS)
    snap = {}

    def on_step(step, state, m):
        if step == SIM_FAIL:
            snap.update(flat_tree(np, convert.train_state_tree(state)))

    try:
        train.main(RESUME_ARGS + ["--ckpt", str(TRAIN_RESUME_CKPT),
                                  "--sim-fail", str(SIM_FAIL)],
                   on_step=on_step)
        raise AssertionError("--sim-fail did not fail")
    except RuntimeError as e:
        if "sim-fail" not in str(e):
            raise
    restored = CheckpointManager(str(TRAIN_RESUME_CKPT)).restore_latest(want)
    got = flat_tree(np, convert.train_state_tree(restored))
    if got.keys() != snap.keys() or not all(
            got[k].dtype == snap[k].dtype
            and torch.equal(got[k].reshape(-1).view(torch.uint8),
                            snap[k].reshape(-1).view(torch.uint8))
            for k in snap):
        raise AssertionError("the restored state is not the saved one")
    resumed = train.main(RESUME_ARGS + ["--ckpt", str(TRAIN_RESUME_CKPT)])
    differ = [n for (n, a), (_, b) in zip(
        want["params"].named_parameters(), resumed["params"].named_parameters())
        if not torch.equal(a, b)]
    print(f"train resume qwen2-0.5b smoke on the card: crashed after step "
          f"{SIM_FAIL}, the restored state equals the saved one bit for bit "
          f"({len(snap)} leaves); resumed to step {int(resumed['step'])}: "
          f"{len(differ)} parameters differ from the uninterrupted run's "
          f"{differ[:4]}", flush=True)
    if differ:
        raise AssertionError("the resumed run is not the uninterrupted one")
    shutil.rmtree(TRAIN_RESUME_CKPT)
    return len(differ)


def _env(values):
    """Set environment variables; returns a function that restores them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)

    def restore():
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    return restore


def _leaves_equal(torch, sharded_state, local_state):
    """Names of the leaves where a sharded train state's gathered tensors
    differ from a one-device state's, bit for bit (parameters, m, v,
    master, count, step)."""
    from repro_torch.distributed import sharding

    def bits(t):
        return t.detach().reshape(-1).view(torch.uint8)

    pairs = [(f"params/{n}", p, dict(local_state["params"].named_parameters())[n])
             for n, p in sharded_state["params"].named_parameters()]
    for k, v in sharded_state["opt"].items():
        if isinstance(v, dict):
            pairs += [(f"opt/{k}/{n}", t, local_state["opt"][k][n])
                      for n, t in v.items()]
        else:
            pairs.append((f"opt/{k}", v, local_state["opt"][k]))
    pairs.append(("step", sharded_state["step"], local_state["step"]))
    return [name for name, a, b in pairs
            if not torch.equal(bits(sharding.full_tensor(a)), bits(b))]


def train_1x1(torch, np, fa, want_losses):
    """Phase 20d: the driver with ``--distributed --mesh local`` over NCCL,
    a world of one (the launcher's environment: a free localhost port):
    phase 20's arguments for TRAIN_1X1_STEPS steps, the sharded train state
    on a 1x1 mesh, a checkpoint at the last step. The losses must equal
    phase 20's first ones bit for bit (one data rank: the one-device
    step's arithmetic), kernel 5 launched 0 times, no collective; the
    checkpoint restored into a one-device train state must equal the
    sharded state bit for bit. Prints ms a step, peak memory and the
    route."""
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.launch import train
    from repro_torch.optim import AdamW
    from repro_torch.train.steps import init_train_state

    free_card(torch)
    shutil.rmtree(TRAIN_1X1_CKPT, ignore_errors=True)
    args = list(TRAIN_ARGS)
    for flag in ("--steps", "--ckpt-every"):
        args[args.index(flag) + 1] = str(TRAIN_1X1_STEPS)
    fa.reset_launches()
    sharding.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    losses, stamps, seen = [], [], {}

    def on_step(step, state, m):
        losses.append(float(m["loss"]))                 # waits for the step
        stamps.append(time.perf_counter())
        if step == 1:
            seen.update(backend=dist.get_backend(), route=sharding.route(
                state["params"].embed.device_mesh, "cuda"),
                mesh=tuple(state["params"].embed.device_mesh.shape))

    restore = _env(dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                        MASTER_ADDR="127.0.0.1", MASTER_PORT="0"))
    try:
        state = train.main(args + ["--distributed", "--mesh", "local",
                                   "--ckpt", str(TRAIN_1X1_CKPT)],
                           on_step=on_step)
    finally:
        restore()
    steps = TRAIN_1X1_STEPS
    ms = (stamps[-1] - stamps[1]) / (steps - 2) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = fa.launches["flash_attention"]
    collectives = dict(sharding.stats)
    equal = losses == want_losses[:steps]
    template = init_train_state(torch.Generator("cuda").manual_seed(1),
                                get_config("qwen2-0.5b"), AdamW())
    restored = CheckpointManager(str(TRAIN_1X1_CKPT)).restore_latest(template)
    del template
    differ = _leaves_equal(torch, state, restored)
    print(f"train 1x1 mesh (--distributed --mesh local, {seen['backend']}, "
          f"mesh {seen['mesh']}, route {seen['route']}): qwen2-0.5b full "
          f"width, {steps} steps of 8 x 1024 tokens; losses "
          f"{[round(x, 4) for x in losses]}, equal to phase 20's first "
          f"{steps} bit for bit {equal}; {ms:.1f} ms a step after 2 "
          f"({8 * 1024 / ms * 1e3:,.0f} tok/s); peak {peak:.2f} GiB; "
          f"collectives {collectives}; kernel 5 launches {launches}; the "
          f"checkpoint at step {steps} restored into a one-device state: "
          f"{len(differ)} leaves differ {differ[:4]}", flush=True)
    if not equal:
        raise AssertionError(f"1x1 losses {losses} != {want_losses[:steps]}")
    if launches or collectives["all_gather"] or collectives["all_reduce"]:
        raise AssertionError("a 1x1 mesh launched kernel 5 or a collective")
    if differ:
        raise AssertionError("the restored state is not the sharded one")
    shutil.rmtree(TRAIN_1X1_CKPT)
    del state, restored
    free_card(torch)
    return dict(losses=losses, ms_per_step=ms, peak_gib=peak,
                route=seen["route"], leaves_differ=len(differ))


def _train_2x2_optimizer():
    from repro_torch.optim import AdamW, wsd_schedule

    return AdamW(lr=wsd_schedule(*TRAIN_2X2_LR), weight_decay=0.01)


def _train_2x2_batches(cfg):
    from repro_torch.data.pipeline import SyntheticZipfLM

    ds = SyntheticZipfLM(cfg.vocab_size, batch=TRAIN_2X2["batch"],
                         seq=TRAIN_2X2["seq"], seed=0)
    return [ds.batch_at(i) for i in range(TRAIN_2X2["steps"])]


def train_rank(rank, world, store, out_dir, ref_path):
    """One rank of phase 20e's 2x2 gloo mesh (spawned; its blocks on
    ``cuda:0``): the sharded state of qwen2-0.5b (``fsdp=True``) drawn as
    the 1x1 run's, each block's shape checked against ``to_shardings``;
    then, once ``ref_path`` exists (the 1x1 run, made meanwhile, is done),
    TRAIN_2X2's steps on the rank's rows; its blocks of the f32 master
    weights held to the same blocks of the 1x1 run's. Saves its numbers to
    ``out_dir/rank<r>.npz``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.train import sharded

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cuda", (2, 2),
                                mesh_dim_names=("data", "model"))
        cfg = dataclasses.replace(get_config("qwen2-0.5b"), fsdp=True)
        opt = _train_2x2_optimizer()
        t = time.perf_counter()
        state = sharded.init_train_state(
            torch.Generator("cuda").manual_seed(0), cfg, opt, mesh)
        setup_s = time.perf_counter() - t
        specs = sharding.state_specs(cfg, state, mesh)
        shards = sharding.to_shardings(mesh, specs)
        leaves = [(f"params/{n}", p, shards["params"][n])
                  for n, p in state["params"].named_parameters()]
        for k in ("m", "v", "master"):
            leaves += [(f"opt/{k}/{n}", x, shards["opt"][k][n])
                       for n, x in state["opt"][k].items()]
        bad_shapes = [name for name, x, sh in leaves
                      if tuple(x.to_local().shape) != sharding.shard_shape(
                          tuple(x.shape), sh.spec, mesh)
                      or tuple(x.placements) != sh.placements]
        sharded_leaves = sum(any(p.is_shard() for p in sh.placements)
                             for _, _, sh in leaves)
        step = sharded.make_sharded_train_step(cfg, opt, mesh)
        while not os.path.exists(ref_path):
            time.sleep(0.05)
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        sharding.reset_stats()
        losses, norms, walls = [], [], []
        for batch in _train_2x2_batches(cfg):
            rows = {k: torch.from_numpy(v).cuda()
                    for k, v in sharded.batch_rows(batch, mesh).items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, rows)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            walls.append(time.perf_counter() - t)
        stats = dict(sharding.stats)
        peak = torch.cuda.max_memory_allocated()
        # Each rank holds its blocks of the master weights to the same
        # blocks of the 1x1 run's; an element is counted once, on the rank
        # of coordinate 0 along each mesh dim its leaf is replicated on.
        ref = torch.load(ref_path, mmap=True)
        coord = mesh.get_coordinate()
        worst, beyond, total = 0.0, 0, 0
        for n, x in state["opt"]["master"].items():
            want = sharding.local_block(ref[n], sharding.Sharding(
                mesh, None, tuple(x.placements))).cuda()
            err = (x.to_local() - want).abs()
            worst = max(worst, float(err.max()))
            if all(c == 0 for c, p in zip(coord, x.placements)
                   if not p.is_shard()):
                beyond += int((err > TRAIN_2X2_TOL["q_lr"]
                               * TRAIN_2X2_LR_SUM).sum())
                total += err.numel()
        res = dict(losses=np.asarray(losses), norms=np.asarray(norms),
                   walls=np.asarray(walls), peak=np.asarray(peak),
                   setup_s=np.asarray(setup_s),
                   route=np.asarray(sharding.route(mesh, "cuda")),
                   bad_shapes=np.asarray(len(bad_shapes)),
                   sharded_leaves=np.asarray(sharded_leaves),
                   leaves=np.asarray(len(leaves)),
                   coord=np.asarray(mesh.get_coordinate()),
                   **{f"stat/{k}": np.asarray(v) for k, v in stats.items()})
        res.update(master_worst=np.asarray(worst),
                   master_beyond=np.asarray(beyond),
                   master_total=np.asarray(total))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def train_2x2(torch, np, fa):
    """Phase 20e: the 1x1 run (one-device steps, the same as a 1x1 mesh's
    bit for bit, phase 20d): qwen2-0.5b at full width and depth, bf16 with
    f32 master weights, TRAIN_2X2's steps of zipf batches; its losses,
    gradient norms and f32 master weights kept. Meanwhile the 2x2 mesh of
    four gloo ranks spawned on ``cuda:0`` (``train_rank``) draws the same
    state, ``fsdp=True``; it steps after the 1x1 run: every block's shape
    as ``to_shardings`` gives it, the losses and gradient norms within
    TRAIN_2X2_TOL of the 1x1 run's, the master weights too (every rank's
    blocks: every element, without a 2 GB gather through gloo).
    Prints per rank ms a step, peak memory (their sum under the card's 80
    GB), the collectives' count, bytes and host seconds, and the route."""
    import tempfile

    import torch.multiprocessing as tmp

    from repro_torch.configs import get_config
    from repro_torch.train.steps import init_train_state, make_train_step

    free_card(torch)
    with tempfile.TemporaryDirectory() as tmpdir:
        # The ranks start and draw their state while the 1x1 run runs;
        # they step once its master weights are written.
        ref_path = str(Path(tmpdir) / "master.pt")
        t = time.perf_counter()
        ranks_job = tmp.start_processes(train_rank, args=(
            4, str(Path(tmpdir) / "store"), tmpdir, ref_path), nprocs=4,
            join=False, start_method="spawn")
        try:
            cfg = get_config("qwen2-0.5b")
            opt = _train_2x2_optimizer()
            state = init_train_state(torch.Generator("cuda").manual_seed(0),
                                     cfg, opt)
            step = make_train_step(cfg, opt)
            want_losses, want_norms = [], []
            for batch in _train_2x2_batches(cfg):
                state, m = step(state, to_device(torch, batch, "cuda"))
                want_losses.append(float(m["loss"]))
                want_norms.append(float(m["grad_norm"]))
            torch.save({n: t.cpu()
                        for n, t in state["opt"]["master"].items()},
                       ref_path + ".tmp")
            del state, step
            free_card(torch)
            os.replace(ref_path + ".tmp", ref_path)
            while not ranks_job.join():
                pass
        finally:
            for proc in ranks_job.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join()
        wall = time.perf_counter() - t
        ranks = []
        for r in range(4):
            with np.load(Path(tmpdir) / f"rank{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
    print(f"train 2x2 mesh: the 1x1 run and four gloo ranks on cuda:0 in "
          f"{wall:.1f} s; "
          f"route {ranks[0]['route']}; 1x1 losses "
          f"{[round(x, 6) for x in want_losses]}, grad norms "
          f"{[round(x, 4) for x in want_norms]}", flush=True)
    peaks = [float(r["peak"]) / 2**30 for r in ranks]
    for r, res in enumerate(ranks):
        ms = float(np.mean(res["walls"][1:])) * 1e3
        print(f"train 2x2 rank {r} (coordinate {res['coord'].tolist()}): "
              f"losses {[round(float(x), 6) for x in res['losses']]}, grad "
              f"norms {[round(float(x), 4) for x in res['norms']]}; "
              f"{ms:.1f} ms a step after 1 (steps "
              f"{[round(float(x) * 1e3, 1) for x in res['walls']]} ms), set-up "
              f"{float(res['setup_s']):.1f} s; peak {peaks[r]:.2f} GiB; "
              f"collectives all_gather {int(res['stat/all_gather'])}, "
              f"all_reduce {int(res['stat/all_reduce'])}, "
              f"{int(res['stat/bytes']):,} bytes, host seconds "
              f"{float(res['stat/all_gather_s']):.2f} gathering, "
              f"{float(res['stat/all_reduce_s']):.2f} reducing; block "
              f"shapes off "
              f"{int(res['bad_shapes'])} of {int(res['leaves'])} leaves "
              f"({int(res['sharded_leaves'])} sharded)", flush=True)
    loss_rel = max(abs(float(x) - w) / abs(w) for res in ranks
                   for x, w in zip(res["losses"], want_losses))
    norm_rel = max(abs(float(x) - w) / abs(w) for res in ranks
                   for x, w in zip(res["norms"], want_norms))
    worst = max(float(r["master_worst"]) for r in ranks)
    beyond = (sum(int(r["master_beyond"]) for r in ranks)
              / sum(int(r["master_total"]) for r in ranks))
    bound = 2 * TRAIN_2X2_LR_SUM + 1e-6
    print(f"train 2x2 against 1x1: losses within {loss_rel:.3e} relative "
          f"(tolerance {TRAIN_2X2_TOL['loss']}), grad norms {norm_rel:.3e} "
          f"(tolerance {TRAIN_2X2_TOL['grad_norm']}); f32 master weights "
          f"within {worst:.3e} (bound {bound:.3e}: 2 x the summed lr), "
          f"{beyond:.3e} of the elements beyond {TRAIN_2X2_TOL['q_lr']} x "
          f"the summed lr (tolerance {TRAIN_2X2_TOL['beyond']}); the four "
          f"peaks sum to {sum(peaks):.2f} GiB", flush=True)
    if any(int(r["bad_shapes"]) for r in ranks):
        raise AssertionError("a block's shape is not to_shardings'")
    if (loss_rel > TRAIN_2X2_TOL["loss"]
            or norm_rel > TRAIN_2X2_TOL["grad_norm"] or worst > bound
            or beyond > TRAIN_2X2_TOL["beyond"]):
        raise AssertionError("the 2x2 mesh's training is not the 1x1 run's")
    if sum(peaks) > 80:
        raise AssertionError(f"the four ranks' peaks sum to {sum(peaks)} GiB")
    if fa.launches["flash_attention"]:
        raise AssertionError("training launched kernel 5")
    return dict(loss_rel=loss_rel, grad_norm_rel=norm_rel,
                master_worst=worst, master_beyond=beyond, peaks_gib=peaks,
                ms_per_step=[float(np.mean(r["walls"][1:])) * 1e3
                             for r in ranks],
                collectives=[{k[5:]: v.item() for k, v in r.items()
                              if k.startswith("stat/")} for r in ranks],
                route=str(ranks[0]["route"]))


def train_phases(torch, np):
    """Phases 20, 20b, 20c, 20d and 20e. Returns their summary for the
    kernels line (kernel 5's launches in training: 0)."""
    from repro_torch.kernels import flash_attention as fa

    full = phase("train full width", train_full_width, torch, np, fa)
    golden = phase("train against the golden", against_train_golden, torch,
                   np, fa)
    families = phase("train every family", train_families, torch, np, fa)
    differ = phase("train resume", train_resume, torch, np)
    mesh_1x1 = phase("train 1x1 mesh", train_1x1, torch, np, fa,
                     full["losses"])
    mesh_2x2 = phase("train 2x2 mesh", train_2x2, torch, np, fa)
    return dict(launches=full["launches"], full_width=full, golden=golden,
                families=families, resume_params_differ=differ,
                mesh_1x1=mesh_1x1, mesh_2x2=mesh_2x2)


# ---------------------------------------------------------------------------
# Sharded serving and the dry-run (phases 21, 21b).
# ---------------------------------------------------------------------------

#: Phase 21: phase 16's serve (qwen2-0.5b at full width and depth, bf16,
#: weights from seed 0, prompt tokens from ``default_rng(0)``) through the
#: sharded prefill and decode steps on a 1x1 NCCL mesh.
SHARDED_SERVE = dict(batch=8, prompt=2048, gen=32)
#: Phase 21b: the dry-run's cells run on the card host, one process each,
#: as (arch, shapes, mesh).
DRYRUN_CELLS = (("qwen2-0.5b", ("all",), "single"),
                ("deepseek-v2-lite-16b", ("prefill_32k",), "single"),
                ("qwen2-0.5b", ("train_4k",), "multi"))
DRYRUN_FIXTURE = ROOT / "tests" / "fixtures" / "dryrun_reference.json"
DRYRUN_OUT = ROOT / "build" / "dryrun"
#: Seconds a dry-run process may take before the phase fails.
DRYRUN_TIMEOUT_S = 400


def serve_loop(torch, prefill, decode, params, batch, cache, prompt, gen):
    """A prefill and ``gen - 1`` greedy decode steps, as ``serve.main``
    runs them: (the logits of every step [gen, B, V], the tokens [B,
    gen])."""
    logits, cache = prefill(params, batch, cache)
    cur = torch.argmax(logits, -1).to(torch.int32)
    every, outs = [logits], [cur]
    for i in range(gen - 1):
        cur, logits, cache = decode(params, cur, cache, prompt + i)
        every.append(logits)
        outs.append(cur)
    torch.cuda.synchronize()
    return torch.stack(every), torch.stack(outs, 1)


def predicted_serve(torch, cfg, mesh, b, p, gen):
    """The dry-run's count of phase 21's sharded run on ``mesh``: its
    prefill and first decode step on fake tensors on the card under
    ``cost.Analysis`` (kernel 5 charged, not launched; the run's peak is
    the prefill's, and each fake decode step takes ~0.5 s of the host).
    Returns (argument bytes, peak bytes, the analysis's result)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed import cost
    from repro_torch.launch import dryrun
    from repro_torch.train import sharded

    with FakeTensorMode():
        params = sharded._sharded_lm(cfg, dryrun._placed_params(cfg, mesh,
                                                                "cuda"))
        cache = sharded.init_cache(cfg, b, p + gen, mesh, device="cuda")
        rows = {"tokens": torch.empty((b, p), dtype=torch.int32,
                                      device="cuda")}
        prefill = sharded.make_sharded_prefill_step(cfg, mesh)
        decode = sharded.make_sharded_decode_step(cfg, mesh)
        with cost.Analysis() as a:
            a.track([params, rows, cache])
            serve_loop(torch, prefill, decode, params, rows, cache, p, 2)
        args = dryrun.argument_size((params, rows, cache))
    return args, a.peak_bytes, a.result()


def serve_sharded(torch, np, fa):
    """Phase 21: phase 16's serve through ``make_sharded_prefill_step`` and
    ``make_sharded_decode_step`` on a 1x1 mesh over NCCL (a world of one,
    a FileStore rendezvous), from the same weights and prompt: every
    step's logits and every token equal to the one-device steps'
    (``serve.main``'s, run here first) bit for bit; kernel 5's launches by
    body, counted (set to 0 just before the sharded run, read just after),
    equal to phase 16's (24 ``mma``, 744 ``split`` and 744 ``combine``); no
    collective. Then the dry-run's count of the same run on fake tensors,
    its bytes beside the allocator's (no bound: PERF.md reads the gap).
    Returns the launches and the readings."""
    import datetime
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding
    from repro_torch.models import lm
    from repro_torch.train import sharded
    from repro_torch.train.steps import make_decode_step, make_prefill_step

    free_card(torch)
    b, p, gen = (SHARDED_SERVE[k] for k in ("batch", "prompt", "gen"))
    cfg = get_config("qwen2-0.5b")
    params = lm.init(torch.Generator("cuda").manual_seed(0), cfg)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, p)).astype(np.int32)).to("cuda")
    t = time.perf_counter()
    want_lg, want_tok = serve_loop(
        torch, make_prefill_step(cfg), make_decode_step(cfg), params,
        {"tokens": tokens}, lm.init_cache(cfg, b, p + gen, device="cuda"), p,
        gen)
    one_s = time.perf_counter() - t
    with tempfile.TemporaryDirectory() as tmpdir:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(tmpdir) / "store"), 1),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            sp = sharded.shard_params(cfg, params, mesh)
            cache = sharded.init_cache(cfg, b, p + gen, mesh, device="cuda")
            rows = sharded.serve_rows({"tokens": tokens}, mesh)
            args = sum(t_.numel() * t_.element_size() for t_ in
                       [*(x.to_local() for x in sp.parameters()),
                        rows["tokens"],
                        *(x.to_local() for x in sharded._leaves(cache))])
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fa.reset_launches()
            sharding.reset_stats()
            t = time.perf_counter()
            got_lg, got_tok = serve_loop(
                torch, sharded.make_sharded_prefill_step(cfg, mesh),
                sharded.make_sharded_decode_step(cfg, mesh), sp, rows, cache,
                p, gen)
            wall = time.perf_counter() - t
            used = dict(fa.launches)
            collectives = sharding.stats["all_gather"] \
                + sharding.stats["all_reduce"]
            measured = torch.cuda.max_memory_allocated() - before + args
            route = sharding.route(mesh, "cuda")
            pred_args, pred_peak, pred = predicted_serve(torch, cfg, mesh, b,
                                                         p, gen)
        finally:
            dist.destroy_process_group()
    lg_equal = torch.equal(got_lg.view(torch.int32), want_lg.view(torch.int32))
    tok_equal = torch.equal(got_tok, want_tok)
    want = {"flash_attention": SERVE_LAUNCHES, **SERVE_BODIES}
    print(f"serve sharded 1x1 ({route}): qwen2-0.5b full width, bf16, batch "
          f"{b} x {p} prompt tokens, {gen} new; logits of every step equal "
          f"to the one-device steps' bit for bit {lg_equal}, tokens "
          f"{tok_equal}; one-device {one_s:.2f} s, sharded {wall:.2f} s; "
          f"flash_attention launches {used} (want {want}); collectives "
          f"{collectives}", flush=True)
    print(f"serve sharded 1x1 bytes: the dry-run's count (fake tensors; the "
          f"prefill and the first decode step) arguments {pred_args:,} B, "
          f"peak {pred_peak:,} B, {pred['flops']:.4e} FLOPs, "
          f"{pred['bytes']:.4e} B moved; the allocator's arguments "
          f"{args:,} B, peak {measured:,} B (its peak over the run less what "
          f"was allocated before, plus the arguments); peak ratio "
          f"{pred_peak / measured:.4f}", flush=True)
    if not (lg_equal and tok_equal):
        raise AssertionError("the sharded serve differs from the one-device "
                             "serve")
    if used != want or collectives:
        raise AssertionError(f"sharded serve launched {used} and "
                             f"{collectives} collectives, want {want}, 0")
    del params, sp, cache, want_lg, got_lg
    free_card(torch)
    return dict(launches=used, wall_s=wall, one_device_s=one_s,
                predicted_argument_bytes=pred_args,
                predicted_peak_bytes=pred_peak, predicted_flops=pred["flops"],
                predicted_bytes=pred["bytes"], argument_bytes=args,
                measured_peak_bytes=measured, route=route)


def _drain(proc, done):
    """Reads a dry-run process's output to its end (so that no pipe
    fills), then notes the time it ended."""
    done["text"] = proc.communicate()[0]
    done["end"] = time.perf_counter()


def dryrun_start():
    """Phase 21b's processes, started: ``python -m
    repro_torch.launch.dryrun`` for each of :data:`DRYRUN_CELLS` on the
    card (fake tensors there; the records under :data:`DRYRUN_OUT`), each
    read by a thread of its own. Returns [(cell, start, process, thread,
    its output and end time once done)]."""
    import shutil
    import threading

    shutil.rmtree(DRYRUN_OUT, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    jobs = []
    for arch, shapes, mesh in DRYRUN_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", *shapes, "--mesh", mesh, "--out",
               str(DRYRUN_OUT), "--force"]
        start = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        done = {}
        reader = threading.Thread(target=_drain, args=(proc, done),
                                  daemon=True)
        reader.start()
        jobs.append(((arch, shapes, mesh), start, proc, reader, done))
    return jobs


def dryrun_cells(jobs):
    """Phase 21b: waits for :func:`dryrun_start`'s processes and reads
    their records: each cell's status and wall; every applicable cell
    ``OK``, its ``argument_size_in_bytes`` and ``model_flops_total`` equal
    to the reference's (``tests/fixtures/dryrun_reference.json``'s full-size
    records), its chips 256 or 512. Returns the records' readings."""
    full = json.loads(DRYRUN_FIXTURE.read_text())["full"]
    out = {}
    for (arch, shapes, mesh), start, proc, reader, done in jobs:
        reader.join(max(0.0, start + DRYRUN_TIMEOUT_S - time.perf_counter()))
        if reader.is_alive():
            proc.kill()
            reader.join()
            raise AssertionError(f"dry-run {arch} {mesh} took over "
                                 f"{DRYRUN_TIMEOUT_S} s")
        text, wall = done["text"], done["end"] - start
        waited = time.perf_counter() - done["end"]
        if proc.returncode:
            raise AssertionError(f"dry-run {arch} {mesh} exited "
                                 f"{proc.returncode}:\n{text[-3000:]}")
        print(f"dry-run process {arch} {' '.join(shapes)} {mesh}: "
              f"{wall:.1f} s (read {waited:.1f} s after it ended)",
              flush=True)
        for path in sorted(DRYRUN_OUT.glob(f"{arch}__*__{mesh}.json")):
            key = path.stem
            if key in out or (shapes != ("all",)
                              and key.split("__")[1] not in shapes):
                continue
            rec = json.loads(path.read_text())
            want = full[key]
            line = f"dry-run {key}: {rec['status']} ({rec['wall_s']} s)"
            if rec["status"] != want["status"]:
                raise AssertionError(f"{line}, want {want['status']}: "
                                     f"{rec.get('error')}")
            if rec["status"] == "OK":
                mem, walk = rec["memory"], rec["hlo_walk"]
                roof = rec["roofline"]
                line += (f" chips {rec['chips']}, route {rec['route']}; per "
                         f"rank {walk['flops']:.4e} FLOPs, {walk['bytes']:.4e} "
                         f"B moved, collective traffic "
                         f"{walk['collective_traffic']:.4e} B, peak "
                         f"{mem['peak_bytes']:,} B; arguments "
                         f"{mem['argument_size_in_bytes']:,} B (reference "
                         f"{want['argument_bytes']:,}); model FLOPs "
                         f"{roof['model_flops_total']:,} (reference "
                         f"{want['model_flops_total']:,}); useful "
                         f"{roof['useful_flops_frac']:.4f}")
                if (mem["argument_size_in_bytes"] != want["argument_bytes"]
                        or roof["model_flops_total"]
                        != want["model_flops_total"]
                        or rec["chips"] != (512 if mesh == "multi" else 256)):
                    raise AssertionError(f"{line}: not the reference's")
                out[key] = dict(
                    flops=walk["flops"], bytes=walk["bytes"],
                    collective_traffic=walk["collective_traffic"],
                    peak_bytes=mem["peak_bytes"],
                    argument_bytes=mem["argument_size_in_bytes"],
                    wall_s=rec["wall_s"])
            else:
                out[key] = dict(status=rec["status"])
            print(line, flush=True)
    want_keys = 4 + 1 + 1
    if len(out) != want_keys:
        raise AssertionError(f"dry-run wrote {sorted(out)}, want "
                             f"{want_keys} records")
    return out


def dryrun_stop(jobs):
    """Kills what is left of :func:`dryrun_start`'s processes and waits
    for their readers."""
    for _, _, proc, reader, _ in jobs:
        if proc.poll() is None:
            proc.kill()
        reader.join()


@contextlib.contextmanager
def dryrun_jobs():
    """A list for :func:`dryrun_start`'s jobs; whatever of their processes
    is left is stopped on exit."""
    jobs = []
    try:
        yield jobs
    finally:
        dryrun_stop(jobs)


def dryrun_phases(torch, np, fa, jobs=None):
    """Phases 21 and 21b: 21b's processes (``jobs``, started by
    :func:`dryrun_start` beside phases 4 to 5b; started here when None)
    run on the host while the card runs the phases before 21b. Returns
    both phases' readings."""
    jobs = dryrun_start() if jobs is None else jobs
    try:
        serve = phase("serve sharded", serve_sharded, torch, np, fa)
        cells = phase("dry-run", dryrun_cells, jobs)
    finally:
        dryrun_stop(jobs)
    return serve, cells


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
    ms = one_kernel_ms(torch, search, "anneal_kernel", 5)
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
        row_ms = one_kernel_ms(torch, lambda: ka.anneal_ladders(
            *tensors, **knobs), "anneal_kernel", 2)
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


#: ``python -m repro_torch.surrogate --smoke`` (phase 10c): its arguments,
#: and no line its output must hold (its exit code says).
SURROGATE_CLI = (["repro_torch.surrogate", "--smoke"], None)


def run_clis(clis):
    """Each CLI of ``clis`` (module arguments, a line its output must hold,
    and optionally variables to add to its environment) on the card in a
    process of its own, one after another: {"module arguments": (the
    finished process, its seconds)}."""
    out = {}
    for args, _, *extra in clis:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.update(*extra)
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", *args], cwd=ROOT, capture_output=True,
            text=True, timeout=300, env=env)
        out[" ".join(args)] = proc, time.perf_counter() - t
    return out


def cli_smokes(job, clis):
    """Waits for ``job`` (``run_clis(clis)``, started while phases 4 to 5b
    ran): every CLI must have exited with 0 and printed its line. Prints
    each one's output and seconds; returns {"module arguments": seconds}."""
    walls = {}
    for (_, ok, *_), (key, (proc, took)) in zip(clis, job.result().items()):
        if proc.returncode != 0 or (ok is not None and ok not in proc.stdout):
            raise AssertionError(f"python -m {key} failed:\n"
                                 f"{proc.stdout[-2000:]}\n"
                                 f"{proc.stderr[-4000:]}")
        print(f"python -m {key} ({took:.1f} s, beside phases 4 to 5b):\n"
              f"{proc.stdout.strip()}", flush=True)
        walls[key] = took
    return walls


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
    ms = one_kernel_ms(torch, search, "anneal_kernel<true>", 5)
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
        guided = one_kernel_ms(torch, lambda: ka.anneal_ladders(
            *tensors, **knobs, guide=ga, q_margin=0, guide_every=1),
            "anneal_kernel<true>", 1, warmup=False)
        unguided = one_kernel_ms(torch, lambda: ka.anneal_ladders(
            *tensors, **knobs), "anneal_kernel<false>", 1, warmup=False)
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


# ---------------------------------------------------------------------------
# Service (phase 10d): the placement service's BENCH stream and frontier, the
# batched fan-out, guided queries and the three CLIs.
# ---------------------------------------------------------------------------

#: benchmarks/service_bench.py's queries: the stream (32 queries over 8
#: graphs, seed 0), 4x4, proposal budget, simulation budget.
SERVICE_STREAM = (32, 8, 0)
SERVICE_GRID = (4, 4)
SERVICE_BUDGET = 2048
SERVICE_MAX_CYCLES = 1_000_000
#: The BENCH ``service`` rows: cycles_anneal of each distinct stream graph
#: (svc_cycles_cached and svc_cycles_fresh equal them) ...
SERVICE_GOLDENS = {
    "svc_arrow_b2_s6_w4_seed1": 510, "svc_arrow_b2_s6_w4_seed2": 510,
    "svc_arrow_b3_s6_w4_seed1": 679, "svc_arrow_b3_s6_w4_seed2": 679,
    "svc_arrow_b4_s6_w4_seed1": 895, "svc_arrow_b4_s6_w4_seed2": 895,
    "svc_arrow_b5_s6_w4_seed1": 1117, "svc_arrow_b5_s6_w4_seed2": 1117,
}
#: ... the stream's counters ...
SERVICE_COUNTERS = dict(queries=32, distinct=8, hits=24, misses=8,
                        simulations=8, anneals=8, batched_anneals=0,
                        hit_rate=0.75)
#: ... and the frontier on the stream's first graph over
#: service_bench.FRONTIER_SPACE: its points' cycles_frontier, and the
#: frontier and swept point counts.
SERVICE_FRONTIER_SPACE = {"scheduler": ("ooo", "inorder"),
                          "eject_policy": ("n_first",),
                          "grid": ((2, 2), (4, 4)),
                          "placement": ("identity", "anneal")}
SERVICE_FRONTIER = {"ooo__n_first__2x2__identity": 937,
                    "ooo__n_first__4x4__identity": 418}
SERVICE_FRONTIER_POINTS = 2
SERVICE_SWEPT_POINTS = 8
#: Anneal seeds of the batched fan-out (one run_batch against solo queries).
SERVICE_SEEDS = (0, 1, 2)
#: Budgets of the two guided queries (rounds 1 and 2 of the default
#: ladder): one surrogate serves both.
SERVICE_GUIDED_BUDGETS = (2048, 8192)
#: The three CLIs, each in a process of its own: (arguments, the line that
#: says it passed).
SERVICE_CLIS = (
    (["repro_torch.core.workloads", "megakernel_bench"],
     "arrow_b4_s10_w8_seed3: 15072 nodes"),
    (["repro_torch.kernels", "--smoke"], "MEGAKERNEL_SMOKE_OK"),
    (["repro_torch.service", "--smoke"], "SERVICE_SMOKE_OK"),
)


def service_phase(torch, np, ka, lod, mk):
    """The slice's main path, counted (the launch counts set to 0 just
    before, read just after): the BENCH ``service`` stream through one
    ``PlacementService`` under ``select`` (the cold stream, the warm
    all-hit replay, a fresh service per distinct graph), the same fresh
    queries under ``megakernel`` (same keys, same answers), the frontier
    through ``explore``, three anneal seeds in one ``run_batch`` against
    three solo queries, and two guided queries sharing one surrogate
    (SERVICE_CLIS run beside phases 4 to 5b). Returns (counts, walls,
    anneal launches {batch, solo})."""
    from repro_torch.core import workloads as wl
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.place.spec import PlacementSpec
    from repro_torch.service import PlacementQuery, PlacementService, explore

    nx, ny = SERVICE_GRID

    def query(g, placement="anneal", engine="select", budget=SERVICE_BUDGET):
        return PlacementQuery(graph=g, nx=nx, ny=ny, budget=budget,
                              cfg=OverlayConfig(
                                  placement=placement, engine=engine,
                                  max_cycles=SERVICE_MAX_CYCLES))

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    stream = wl.service_stream(*SERVICE_STREAM)
    for k in (ka, lod, mk):
        k.reset_launches()
    walls = {}

    svc = PlacementService()
    first, cached = {}, {}

    def cold():
        for name, g in stream:
            r = svc.query(query(g))
            if name in first:
                if not (r.cached and r.cycles == first[name][1].cycles):
                    raise AssertionError(f"service {name}: a repeat query "
                                         f"missed the cache")
                cached[name] = r.cycles
            elif r.cached:
                raise AssertionError(f"service {name}: a first sighting "
                                     f"claimed a hit")
            else:
                first[name] = (g, r)

    _, walls["stream"] = timed(cold)
    rep = svc.report()
    seen = dict(queries=rep["queries"], distinct=len(first),
                hits=rep["cache_hits"], misses=rep["cache_misses"],
                simulations=rep["simulations"], anneals=rep["anneals"],
                batched_anneals=rep["batched_anneals"],
                hit_rate=rep["cache_hit_rate"])
    print(f"service stream: {seen} (BENCH {SERVICE_COUNTERS}), wall "
          f"{walls['stream']:.3f} s", flush=True)
    if seen != SERVICE_COUNTERS:
        raise AssertionError("service stream: the counters differ from BENCH")
    sims = rep["simulations"]
    replay, walls["replay"] = timed(
        lambda: [svc.query(query(g)) for _, g in stream])
    if not all(r.cached for r in replay) or svc.counters["simulations"] != sims:
        raise AssertionError("service replay: a warm query missed the cache")
    fresh, walls["fresh"] = timed(lambda: {
        name: PlacementService().query(query(g))
        for name, (g, _) in first.items()})
    mega, walls["fresh_megakernel"] = timed(lambda: {
        name: PlacementService().query(query(g, engine="megakernel"))
        for name, (g, _) in first.items()})
    for name, (g, r0) in sorted(first.items()):
        f, m = fresh[name], mega[name]
        print(f"service {name} ({g.num_nodes} nodes): cycles {r0.cycles}, "
              f"cached {cached[name]}, fresh {f.cycles}, fresh under "
              f"megakernel {m.cycles} (BENCH {SERVICE_GOLDENS[name]}), key "
              f"{r0.key:#x}", flush=True)
        if not (r0.cycles == cached[name] == f.cycles == m.cycles
                == SERVICE_GOLDENS[name]
                and r0.key == f.key == m.key
                and r0.stats == f.stats == m.stats
                and np.array_equal(r0.node_pe, f.node_pe)
                and np.array_equal(r0.node_pe, m.node_pe)):
            raise AssertionError(f"service {name}: cached, fresh and "
                                 f"megakernel answers differ from BENCH")
    print(f"service walls: stream {walls['stream']:.3f} s, replay "
          f"{walls['replay'] * 1e3:.2f} ms, fresh {walls['fresh']:.3f} s, "
          f"fresh under megakernel {walls['fresh_megakernel']:.3f} s",
          flush=True)

    g0 = stream[0][1]
    rec, walls["frontier"] = timed(lambda: explore(
        g0, space=SERVICE_FRONTIER_SPACE, budget=SERVICE_BUDGET,
        max_cycles=SERVICE_MAX_CYCLES))
    front = {p["name"]: p["cycles"] for p in rec["frontier"]}
    print(f"service frontier on {stream[0][0]}: points "
          f"{ {p['name']: p['cycles'] for p in rec['points']} }, frontier "
          f"{front} (BENCH {SERVICE_FRONTIER}), "
          f"{len(rec['frontier'])}/{len(rec['points'])}, batched anneals "
          f"{rec['report']['batched_anneals']}, wall "
          f"{walls['frontier']:.3f} s", flush=True)
    if (front != SERVICE_FRONTIER
            or len(rec["frontier"]) != SERVICE_FRONTIER_POINTS
            or len(rec["points"]) != SERVICE_SWEPT_POINTS):
        raise AssertionError("service frontier differs from BENCH")

    def seeded(s):
        return query(g0, PlacementSpec(strategy="anneal", seed=s))

    fan = {}
    before = ka.launches["anneal"]
    bsvc = PlacementService()
    batched, walls["fan_out"] = timed(
        lambda: bsvc.run_batch([seeded(s) for s in SERVICE_SEEDS]))
    fan["batch"] = ka.launches["anneal"] - before
    before = ka.launches["anneal"]
    solo, walls["solo"] = timed(
        lambda: [PlacementService().query(seeded(s)) for s in SERVICE_SEEDS])
    fan["solo"] = ka.launches["anneal"] - before
    print(f"service fan-out: seeds {SERVICE_SEEDS} cycles "
          f"{[r.cycles for r in batched]} in one run_batch ({fan['batch']} "
          f"anneal launch, {walls['fan_out']:.3f} s), solo "
          f"{[r.cycles for r in solo]} ({fan['solo']} launches, "
          f"{walls['solo']:.3f} s)", flush=True)
    if not (bsvc.counters["batched_anneals"] == len(SERVICE_SEEDS)
            and fan == {"batch": 1, "solo": len(SERVICE_SEEDS)}
            and all(np.array_equal(b.node_pe, r.node_pe)
                    and (b.cycles, b.stats) == (r.cycles, r.stats)
                    for b, r in zip(batched, solo))):
        raise AssertionError("service fan-out differs from the solo queries")

    gsvc = PlacementService()
    spec = PlacementSpec(strategy="anneal", guide="surrogate")
    before = ka.launches["anneal_guided"]
    guided, walls["guided"] = timed(lambda: [
        gsvc.query(query(g0, spec, budget=b))
        for b in SERVICE_GUIDED_BUDGETS])
    launched = ka.launches["anneal_guided"] - before
    print(f"service guided: budgets {SERVICE_GUIDED_BUDGETS} cycles "
          f"{[r.cycles for r in guided]}, surrogate fits "
          f"{gsvc.counters['surrogate_fits']}, simulations "
          f"{gsvc.counters['simulations']}, guided launches {launched}, wall "
          f"{walls['guided']:.3f} s", flush=True)
    if not (gsvc.counters["surrogate_fits"] == 1 and launched == 2
            and all(r.cycles and not r.cached for r in guided)):
        raise AssertionError("service guided queries did not share one "
                             "surrogate")

    counts = dict(lod.launches, **mk.launches, **ka.launches)
    print(f"service kernel launches: {counts}", flush=True)
    for k in ("schedule_step", "mega_chunk_batched", "anneal",
              "anneal_guided"):
        if counts[k] == 0:
            raise AssertionError(f"the service path never launched {k}")
    if counts["mega_chunk_global"]:
        raise AssertionError("a service memory took the global body")
    return counts, walls, fan


# ---------------------------------------------------------------------------
# Phase 10e: the sharded engines (``run(..., mesh=)``).
# ---------------------------------------------------------------------------

#: The 1x1 mesh's runs: n15072 ``ooo`` and ``inorder`` (the Fig. 1 pair) under
#: both engines, solo; the reference's batch of ``ooo``, ``inorder`` and
#: ``scan`` (budget 200) on one criticality-ordered memory under the
#: megakernel; ``ooo`` traced under the megakernel; n470772 ``ooo`` under the
#: megakernel.
SHARD_ROW = "n15072"
SHARD_ENGINES = ("select", "megakernel")
SHARD_BATCH = (dict(scheduler="ooo"), dict(scheduler="inorder"),
               dict(scheduler="scan", max_cycles=200))
SHARD_DEEP = "n470772"
#: The 2x2 mesh of four gloo ranks on the one card: (policy, engine) runs on
#: SHARD_ROW; ``megakernel`` runs the tensor chunk on a multi-shard mesh.
SHARD_2X2 = (("ooo", "select"), ("inorder", "select"), ("ooo", "megakernel"))
#: The 2x2 runs ``--full-checks`` adds: the tensor engine's, whose chunk the
#: ``megakernel`` run above runs too.
SHARD_2X2_FULL = (("ooo", "tensor"), ("inorder", "tensor"))
SHARD_TIMEOUT_S = 120


def _result_arrays(np, r) -> dict:
    """A SimResult's counters, values and trace leaves as numpy arrays."""
    out = {f: np.asarray(getattr(r, f)) for f in (
        "cycles", "done", "delivered", "deflections", "busy_cycles",
        "noc_deflections", "eject_deflections", "values")}
    if r.telemetry is not None:
        out.update({f"telem/{k}": v for k, v in r.telemetry.traces.items()})
    return out


def same_arrays(np, got: dict, want: dict) -> bool:
    """Two ``_result_arrays``: the same keys, equal as bit patterns."""
    return got.keys() == want.keys() and all(
        np.array_equal(got[k].view(np.int32) if got[k].dtype == np.float32
                       else got[k], want[k].view(np.int32)
                       if want[k].dtype == np.float32 else want[k])
        for k in want)


def shard_rank(rank, world, store, out_dir, runs):
    """One rank of the 2x2 gloo mesh (spawned; its tile on ``cuda:0``):
    the ``runs`` (policy, engine) on SHARD_ROW, each result, its wall,
    the halo's exchanges and seconds and the leading-one launches saved to
    ``out_dir/rank<r>.npz``."""
    import datetime

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch
    from repro_torch.core import distributed
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.kernels import lod, megakernel

    torch.cuda.set_device(0)
    torch.set_num_threads(1)    # four ranks share the host's cores
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        g, _, memories, _ = row_setup(SHARD_ROW)
        res = {"route": np.asarray(distributed.route(mesh))}
        for policy, engine in runs:
            crit = policy == "ooo"
            cfg = OverlayConfig(scheduler=policy, engine=engine)
            lod.reset_launches()
            megakernel.reset_launches()
            distributed.reset_stats()
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = repro_torch.run(memories[crit], cfg, mesh=mesh)
            torch.cuda.synchronize()
            key = f"{policy}/{engine}"
            res[f"{key}/wall"] = np.asarray(time.perf_counter() - t)
            for k, v in _result_arrays(np, r).items():
                res[f"{key}/{k}"] = v
            for k, v in {**distributed.stats, **lod.launches,
                         "mega_chunks": sum(megakernel.launches.values())
                         }.items():
                res[f"{key}/stat/{k}"] = np.asarray(v)
            dist.barrier()
        np.savez(Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def sharded_phase(torch, np, graphs, lod, mk, mega_results, select_results,
                  full=False):
    """Phase 10e. (a) A 1x1 mesh in this process, over NCCL with a world of
    one (a FileStore rendezvous): the SHARD_ROW pair under both engines, the
    reference's batch, ``ooo`` traced and SHARD_DEEP ``ooo``, counted (the
    launch counts set to 0 just before, read just after), each equal to its
    non-mesh run leaf for leaf, traces included, at the goldens; no
    collective is launched. (b) A 2x2 mesh of four gloo ranks spawned on the
    one card: SHARD_2X2 (and SHARD_2X2_FULL where ``full``), every rank's
    result equal to the non-mesh run bit for bit; each run's wall,
    simulated cycles/s, halo µs a cycle and route, and kernel 2's
    launches. Returns the counts of (a) and the summed
    leading-one launches of (b)."""
    import datetime
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as tmp
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch
    from repro_torch.core import distributed
    from repro_torch.core.overlay import OverlayConfig
    from repro_torch.telemetry import TelemetrySpec

    _, ref = graphs.graph(SHARD_ROW)
    goldens = ROWS[SHARD_ROW][1]
    crit = graphs.memory(SHARD_ROW, "ooo")
    # The non-mesh runs each mesh run is held to (earlier phases' where
    # they ran it), made before the counted window.
    solo = {}
    for sched in goldens:
        for engine in SHARD_ENGINES:
            earlier = (select_results if engine == "select"
                       else mega_results).get((SHARD_ROW, sched))
            solo[sched, engine] = earlier or repro_torch.run(
                graphs.memory(SHARD_ROW, sched),
                OverlayConfig(scheduler=sched, engine=engine))
    batch_cfgs = [OverlayConfig(engine="megakernel", **kw)
                  for kw in SHARD_BATCH]
    solo["batch"] = repro_torch.run(crit, batch=batch_cfgs)
    traced = OverlayConfig(engine="megakernel", telemetry=TelemetrySpec())
    solo["traced"] = repro_torch.run(crit, traced)
    deep = graphs.memory(SHARD_DEEP, "ooo")
    solo["deep"] = mega_results.get((SHARD_DEEP, "ooo")) or repro_torch.run(
        deep, OverlayConfig(engine="megakernel"))

    def check(label, got, want, golden=None):
        same = same_arrays(np, _result_arrays(np, got),
                           _result_arrays(np, want))
        print(f"sharded 1x1 {label}: cycles {got.cycles}"
              + (f" (golden {golden})" if golden else "")
              + f", equal to the non-mesh run leaf for leaf {same}",
              flush=True)
        if not same or (golden and got.cycles != golden):
            raise AssertionError(f"sharded 1x1 {label} differs")

    with tempfile.TemporaryDirectory() as tmpdir:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(tmpdir) / "store"), 1),
            rank=0, world_size=1,
            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            print(f"sharded 1x1: backend {dist.get_backend()}, route "
                  f"{distributed.route(mesh)}", flush=True)
            lod.reset_launches()
            mk.reset_launches()
            distributed.reset_stats()
            for sched, golden in goldens.items():
                for engine in SHARD_ENGINES:
                    cfg = OverlayConfig(scheduler=sched, engine=engine)
                    r = repro_torch.run(graphs.memory(SHARD_ROW, sched), cfg,
                                        mesh=mesh)
                    check(f"{SHARD_ROW} {sched} {engine}", r,
                          solo[sched, engine], golden)
                    if not np.allclose(r.values, ref, rtol=1e-5, atol=1e-5):
                        raise AssertionError(f"{sched} {engine}: values")
            for i, r in enumerate(repro_torch.run(crit, mesh=mesh,
                                                  batch=batch_cfgs)):
                check(f"{SHARD_ROW} batch {batch_cfgs[i].scheduler} "
                      f"(budget {batch_cfgs[i].max_cycles}) megakernel", r,
                      solo["batch"][i])
            check(f"{SHARD_ROW} ooo megakernel traced",
                  repro_torch.run(crit, traced, mesh=mesh), solo["traced"],
                  goldens["ooo"])
            check(f"{SHARD_DEEP} ooo megakernel",
                  repro_torch.run(deep, OverlayConfig(engine="megakernel"),
                                  mesh=mesh), solo["deep"],
                  ROWS[SHARD_DEEP][1]["ooo"])
            counts = {**lod.launches, **mk.launches}
            collectives = dict(distributed.stats)
        finally:
            dist.destroy_process_group()
    print(f"sharded 1x1 launches through the mesh path: {counts}; "
          f"collectives {collectives}", flush=True)
    for k in ("schedule_step", "mega_chunk", "mega_chunk_batched",
              "mega_chunk_traced"):
        if counts[k] == 0:
            raise AssertionError(f"the 1x1 mesh path never launched {k}")
    if any(collectives[k] for k in ("halo", "all_reduce", "all_gather")):
        raise AssertionError(f"a 1x1 mesh launched collectives {collectives}")

    # (b) The non-mesh runs of the 2x2 configs, then the four ranks.
    runs = SHARD_2X2 + (SHARD_2X2_FULL if full else ())
    want = {}
    for policy, engine in runs:
        r = (solo.get((policy, engine)) or repro_torch.run(
            graphs.memory(SHARD_ROW, policy),
            OverlayConfig(scheduler=policy, engine=engine)))
        want[policy, engine] = _result_arrays(np, r)
    with tempfile.TemporaryDirectory() as tmpdir:
        t = time.perf_counter()
        tmp.start_processes(shard_rank, args=(
            4, str(Path(tmpdir) / "store"), tmpdir, runs), nprocs=4,
            join=True, start_method="spawn")
        print(f"sharded 2x2: four gloo ranks on cuda:0 in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        ranks = []
        for r in range(4):
            with np.load(Path(tmpdir) / f"rank{r}.npz") as z:
                ranks.append({k: z[k] for k in z.files})
    print(f"sharded 2x2 route: {ranks[0]['route']}", flush=True)
    launches_2x2 = {}
    for policy, engine in runs:
        key = f"{policy}/{engine}"
        same = all(same_arrays(np, {k[len(key) + 1:]: v for k, v in res.items()
                                    if k.startswith(key + "/") and "/stat/"
                                    not in k and not k.endswith("/wall")},
                               want[policy, engine]) for res in ranks)
        r0 = ranks[0]
        cycles, wall = int(r0[f"{key}/cycles"]), float(r0[f"{key}/wall"])
        halo = int(r0[f"{key}/stat/halo"])
        halo_us = float(r0[f"{key}/stat/halo_s"]) / cycles * 1e6
        lods = {k: sum(int(res[f"{key}/stat/{k}"]) for res in ranks)
                for k in lod.launches}
        for k, v in lods.items():
            launches_2x2[k] = launches_2x2.get(k, 0) + v
        mega = sum(int(res[f"{key}/stat/mega_chunks"]) for res in ranks)
        chunk = ("megakernel" if mega else
                 f"{'tensor' if engine != 'select' else 'select'} (eager)")
        print(f"sharded 2x2 {SHARD_ROW} {policy} {engine}: cycles {cycles}, "
              f"every rank equal to the non-mesh run {same}, wall "
              f"{wall:.3f} s, {cycles / wall:.0f} cycles/s, halo "
              f"{halo} exchanges on rank 0, {halo_us:.1f} µs a cycle "
              f"(two exchanges), reduces {int(r0[f'{key}/stat/all_reduce'])}"
              f", chunk {chunk}, leading-one launches (4 ranks) {lods}",
              flush=True)
        if not same or cycles != goldens[policy]:
            raise AssertionError(f"sharded 2x2 {key} differs")
        if engine == "megakernel" and mega:
            raise AssertionError("the megakernel ran on a multi-shard mesh")
    if launches_2x2["schedule_step"] == 0:
        raise AssertionError("the 2x2 mesh never launched schedule_step")
    return counts, launches_2x2


def start_builds(_build, sources):
    """Start one nvcc per source, all at once, in threads that end with
    their builds. Returns source -> a future of the build's seconds
    (counted from this call); :func:`wait_build` waits for one."""
    pool = ThreadPoolExecutor(len(sources))
    t = time.perf_counter()

    def timed(source):
        _build.build(source)
        return time.perf_counter() - t

    jobs = {source: pool.submit(timed, source) for source in sources}
    pool.shutdown(wait=False)
    return jobs


def wait_build(_build, jobs, *sources):
    """Wait for the builds of ``sources`` (:func:`start_builds`), load each
    library, print its seconds and its ptxas lines."""
    for source in sources:
        seconds = jobs[source].result()
        _build.library(source)
        print(f"build {source}: {seconds:.1f} s\n--- {source}\n"
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
    ap.add_argument("--full-checks", action="store_true",
                    help="every case of the kernel checks (phases 4, 5 and "
                         "5b) and the 2x2 mesh's tensor-engine runs, not "
                         "only the main path's eject configuration where "
                         "tests/test_torch_cuda.py holds the others")
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

    # The CLIs' thread ends (waiting for the CLI it runs) before the
    # directory they write into is removed; phase 21b's processes are
    # stopped whatever happens.
    with tempfile.TemporaryDirectory() as cli_out, ProcessPoolExecutor(
            4, mp_context=multiprocessing.get_context("spawn")) as pool, \
            ThreadPoolExecutor(1) as thread, ThreadPoolExecutor(1) as loader, \
            dryrun_jobs() as jobs:
        return run_phases(torch, np, args, pool, thread, loader, cli_out,
                          jobs)


def run_phases(torch, np, args, pool, thread, loader, cli_out,
               jobs) -> int:
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
    # The four builds start together; each is waited for at its first use:
    # lod.cu here, megakernel.cu after phase 3, anneal.cu by the CLIs'
    # thread and phase 10b, flash_attention.cu after phase 5b.
    builds = start_builds(_build, [lod.SOURCE, mk.SOURCE, fa.SOURCE,
                                   ka.SOURCE])
    phase("build", wait_build, _build, builds, lod.SOURCE)

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
    phase("build megakernel.cu (wait)", wait_build, _build, builds, mk.SOURCE)

    # The CLIs run on the card in processes of their own while phases 4 to
    # 5b check kernels (nothing there is timed); they are read before phase 6.
    # Phase 21b's dry-run processes start here too (fake tensors: nothing is
    # allocated on the card); they are read after phase 21.
    # The CLIs run the anneal kernel: their thread waits for its build.
    clis = (SURROGATE_CLI, *SERVICE_CLIS, telemetry_cli(cli_out))
    def anneal_then_clis():
        builds[ka.SOURCE].result()
        return run_clis(clis)

    cli_job = thread.submit(anneal_then_clis)
    jobs.extend(dryrun_start())
    # qwen2-vl-72b's and dbrx-132b's f32 golden models are drawn into the
    # card, one after the other, while phases 4 to 5b run (nothing there is
    # timed and little of the card is used).
    big_models = {arch: loader.submit(recipe_model, torch, np, arch, path)
                  for arch, path in BIG_GOLDENS.items()}
    full = args.full_checks
    mega_err, cases, traced_err, traced_cases = phase(
        "megakernel check", check_megakernel, torch, np, graphs, mk,
        args.mega_rows, full)
    print(f"megakernel equals its plain version in {cases} cases, max abs "
          f"error {mega_err}; traced in {traced_cases} cases, max abs error "
          f"{traced_err}", flush=True)
    batch_err, batch_cases, t_err, t_cases = phase(
        "batched megakernel check", check_batched_megakernel, torch, graphs,
        mk, args.mega_rows, full)
    traced_err, traced_cases = max(traced_err, t_err), traced_cases + t_cases
    print(f"batched megakernel equals its plain version in {batch_cases} "
          f"cases, max abs error {batch_err}; traced in {t_cases} cases, max "
          f"abs error {t_err}", flush=True)

    replay_err, replay_cases, t_err, t_cases = phase(
        "replayed chunk check", check_replayed_chunks, torch, graphs, mk,
        full)
    print(f"replayed chunks equal the eager chunks in {replay_cases} cases, "
          f"max abs error {replay_err}; traced in {t_cases} cases, max abs "
          f"error {t_err}", flush=True)
    phase("build flash_attention.cu (wait)", wait_build, _build, builds,
          fa.SOURCE)
    bf16 = {}
    big = phase("qwen2-vl and dbrx goldens", big_goldens, torch, np, fa,
                big_models, bf16)
    cli_walls = phase("CLI smokes", cli_smokes, cli_job, clis)
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
    tel = phase("telemetry", telemetry_phase, torch, np, graphs, mk, cli_out,
                cli_walls[" ".join(clis[-1][0])])
    solo_walls = phase("full-card sweeps", full_card_sweeps, torch, np, graphs,
                       mk)
    phase("batched select", batched_select, torch, np, lod)
    phase("build anneal.cu (wait)", wait_build, _build, builds, ka.SOURCE)
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
    guided_t = phase("guided anneal time", guided_times, torch, np, ka)
    service_counts, service_walls, service_fan = phase(
        "service", service_phase, torch, np, ka, lod, mk)
    service_clis = {" ".join(a): cli_walls[" ".join(a)]
                    for a, _ in SERVICE_CLIS}
    shard_counts, shard_2x2 = phase("sharded", sharded_phase, torch, np,
                                    graphs, lod, mk, mega_results,
                                    select_results, full)

    mega_timed = phase("megakernel time", megakernel_times, torch, graphs, mk)
    scaling = phase("batch scaling", batch_scaling, torch, graphs, mk,
                    solo_walls["sweep_ooo"])
    nodes, replay_runs = phase("profiles", profiles, torch, graphs)
    flash = lm_phases(torch, np, bf16, big)
    flash["train"] = train_phases(torch, np)
    flash["train_launches"] = flash["train"]["launches"]
    serve_1x1, dry = dryrun_phases(torch, np, fa, jobs)
    flash["sharded_serve_launches"] = serve_1x1["launches"]
    flash["sharded_serve"] = serve_1x1
    flash["dryrun"] = dry

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
        if name == "schedule_step":
            row.update(service_launches=service_counts[name])
        row.update(mesh_1x1_launches=shard_counts[name],
                   mesh_2x2_launches=shard_2x2[name])
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
        body_launches=mega_counts["mega_chunk_shared"],
        service_launches=service_counts["mega_chunk"],
        mesh_1x1_launches=shard_counts["mega_chunk"]))
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
        shape=gt["shape"], K=MEGA_K, body="global",
        service_launches=service_counts["mega_chunk_global"]))
    line.append(dict(
        name="mega_chunk_traced", route="cuda", source=MEGA_SOURCE,
        replaces=MEGA_TRACED_REPLACES, launches=tel["launches"],
        max_abs_err=traced_err, equal=traced_err == 0, ms=tel["ms"],
        plain_ms=tel["plain_ms"],
        bound_ms=tel["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, call_ms=tel["call_ms"], shape=tel["shape"],
        K=MEGA_K, body="shared", traced_ms=tel["traced_ms"],
        untraced_ms=tel["untraced_ms"], cases=traced_cases,
        spec="TelemetrySpec()", walls_s=tel["walls"],
        service_launches=service_counts["mega_chunk_traced"],
        mesh_1x1_launches=shard_counts["mega_chunk_traced"]))
    bt = scaling[BATCH_TIMED_B]
    line.append(dict(
        name="mega_chunk_batched", route="cuda", source=MEGA_SOURCE,
        replaces=MEGA_REPLACES + " (batched=True)",
        launches=batch_counts["mega_chunk_batched"], max_abs_err=batch_err,
        equal=batch_err == 0, ms=bt["ms"], plain_ms=bt["plain_ms"],
        bound_ms=bt["bytes"] / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, call_ms=bt["call_ms"], shape=bt["shape"], K=MEGA_K,
        body="shared", body_launches=batch_counts["mega_chunk_shared"],
        service_launches=service_counts["mega_chunk_batched"],
        mesh_1x1_launches=shard_counts["mega_chunk_batched"]))
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
            "mega_chunk_global")},
        service_launches=service_counts["anneal"],
        service_fan_out_launches=service_fan, service_walls_s=service_walls,
        service_cli_walls_s=service_clis))
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
            "mega_chunk_global")},
        service_launches=service_counts["anneal_guided"]))
    # The card's line again, where a reader of the output's tail finds it.
    print(card_line(), flush=True)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
