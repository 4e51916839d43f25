#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (roc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--deep [--old DIR]]
    python3 chip_smoke.py --gather-race [out.json] [--old DIR]

The Reddit and products shapes are built on the host by a process of
their own (:func:`prep_datasets`) and saved as .npy in a temporary
directory that every later phase maps; phase 12 runs meanwhile, right
after the ragged checks, with phase 23's host work (the converter's
runs) in this process beside it and its card work after it.  Each
phase child (12, 14-19) and the kill drill's children are started one
phase ahead and wait for their turn
(:class:`_Child`), so a process's start overlaps the phase before.
Phases 13 and 14 and 15 and 16 share the card two at a time, 17, 19,
20 and 21 four (:func:`_run_together`; no gate of theirs reads a time), and 18,
whose drills key on measured latency, runs alone, last.  ``--deep``
runs them one after another (their times then stand alone) and adds
the timed work that gates nothing (:data:`DEEP`); the default run
drives every path and holds every check.

Phases (any failure exits nonzero):

1. card: needs CUDA; prints the card's name and power limit and sets
   full-fp32 matmuls;
2. build: compiles the kernels from roc_tpu_torch/kernels/csrc;
3. kernels: builds the 602-256-41 GCN's graph (V = 232,965, average
   degree ~493, Reddit's shape; synthetic, from a seed) and holds each
   CUDA kernel (K1, its relu-masked form, K2, K3 with its row_ptr
   pre-pass, K4) against its plain PyTorch version on the card, at the
   shapes the forward and backward give it (K3 and K4 at their default
   slice width) and on a small ragged case (K3 and K4 at every slice
   width), and times kernel, plain version, one PyTorch library call (for
   the masked K1, the chain of calls the backward ran before it) and the
   card's least time for the same work: kernel and library call by CUDA
   events over back-to-back calls (``ms``, host cost included where it
   exceeds the device's) and by torch.profiler's device time
   (``device_ms``; null where it reads below the bound, the reading kept
   as ``device_ms_below_bound``);
   race: every slice width of K3 and K4 (16, 32, 64, 128 and unsliced)
   at F = 256 and F = 41 over the full graph held to the plain version
   (with --deep timed in turns, with its gather rate and HBM rate, and
   the fastest and the ties beside the default); all of it again in
   bf16 (K1 and K2 bit for bit, K3 and K4
   within one bf16 ulp of each row's magnitude, every instance launched
   twice for equal bits);
   the SGC's raw width too: K1, K2 and K4 at F = 602 in fp32 (the
   kernel table's ``akx_shapes``: the SGC on 'cuda' with features on the
   card runs them there; the host tier's walk runs K3, phase 15);
   with --deep the gather races (:func:`gather_races`, also alone as
   ``--gather-race``): the gather's ceiling (K4 over sequential, random
   and L1-window ids) and K3 and K4 at every shape of PERF.md's kernel
   table at every slice width, with ``--old DIR`` against the kernels
   of the checkout DIR in turns;
4. slice (serve): requests through Server on the kernel route, each of
   1, 8, 64 and 512 rows 20 times one after another (per size the
   median, p90, max, every time and its dispatch ms) and four together,
   with the launch counters zeroed just before; in fp32 the first 8- and
   64-row requests go straight to Predictor.query under torch.profiler
   (their device ms and host ops by self time: the first 64-row request
   was the slow one); checks that K1, K2 and K4 ran and that the served
   rows match the same forward on the plain route on the card;
5. train parity: from the same Glorot weights, dropout 0, 3 steps
   through Trainer on 'cuda', 'cuda_csr' and the plain 'ell' route;
   every step's loss within rtol 1e-4 of the plain route's, and the
   weights' max difference and share off by more than 1e-3 printed;
6. train slice: with the counters zeroed just before, 10 epochs with
   dropout 0.5 and an eval every 5 through Trainer on 'cuda' and on
   'cuda_csr'; losses finite, the train loss falling from epoch 4 to
   epoch 9, all four kernels launched, and the masked K1 in every run;
7. train profile: 3 steady steps per kernel route under torch.profiler,
   device time by kernel group, the device's idle share, and every
   kernel of the "other" group with its launches a step;
8. mixed precision, each path with the counters zeroed just before:
   ~8 requests through Server in 'mixed' (K1, K2 and K4 ran in bf16
   only; rows against the plain route in 'mixed' and the fp32 route),
   3 parity steps in 'mixed' on 'cuda', 'cuda_csr' and 'ell', 10 epochs
   in 'mixed' on 'cuda' and 'cuda_csr' and in 'bfloat16' on 'cuda'
   (every bf16 kernel ran, the train loss falls), and with --deep a
   'mixed' profile;
9. dist_p1, the partitioned trainer (parallel/distributed.py) at world
   size 1 over NCCL in this process, in fp32 and in 'mixed': 3 parity
   steps from the same weights, dropout 0, on 'cuda' and 'cuda_csr', each
   objective within the parity tolerance of Trainer's on the same route;
   then, with the counters zeroed just before, 10 epochs with dropout 0.5
   on both routes (the train loss falls, every kernel of the dtype ran,
   the masked K1 too), ``epoch_ms`` beside Trainer's, and with --deep
   in fp32 the step profile of phase 7 (the collectives' device time in its own
   group);
10. dist_p2, two fresh rank processes on this one card over gloo (NCCL
   takes one rank per card), each holding one part of the edge-balanced
   split: K1/K2 on part_nodes rows, K3/K4 reading 2 * part_nodes gathered
   rows, checked against their plain versions at those shapes; 3 steps
   on 'cuda' in fp32 from the same weights, each objective within the
   fp32 parity tolerance of Trainer's, the logits after them within
   1e-4 * max|logit| of Trainer's; the bounds, part shapes, step wall ms
   and the share of it the step's collectives take when timed alone (two
   contexts time-slicing one card and gloo's host staging set that time:
   a layout check, not a speed number);
11. recovery, the checkpoint path (utils/checkpoint.py, resilience/):
   10 epochs with dropout 0.5 through Trainer.train, then from the same
   seed through train_with_recovery with an async keep-3 rotation
   saving every 2 epochs, on 'cuda' in fp32 and on 'cuda_csr' in
   'mixed': params, Adam state and every objective equal bit for bit;
   the kill drill in two fresh processes mapping the dataset from .npy
   (one killed by kill_in_async_save at epoch 4, leaving ck.4 a shard
   without a manifest; the identical job resumes from ck.2 with no
   corrupt_fallback and ends on the uninterrupted fp32 run's bits); the
   nan_grads drill on 'cuda_csr' (one retry, a finite loss); the final
   checkpoint's params (restore_params_only) served through Server,
   each row equal to Trainer.predict's bit for bit; the checkpointed
   run's wall per steady epoch beside the plain run's (run first and
   again last), with --deep beside rounds ending in the guard alone and
   in guard + snapshot, and per save block, write and commit ms and
   bytes, async and sync, and the finite guard's ms; the children's
   set-up;
   every kernel launched, with the counts zeroed before the fp32 path
   and again before the mixed one;
12. zoo, the model zoo (roc_tpu_torch/models/) at ogbn-arxiv's shape
   (V = 169,343, ~4.7 M directed edges, synthetic from a seed; 128 input
   features, 40 classes): K1-K4 against their plain versions at F = 128
   in fp32 and bf16; then SAGE-mean (AVG), SAGE with GraphNorm, SAGE-pool
   (MAX), GIN with learnable eps, SGC (k = 2), APPNP (k = 10), GCNII (8
   layers of 256) and GAT (1 head; 8 heads in 'mixed' only), in fp32 and
   'mixed': a family with a sum takes phase 5's parity steps on 'cuda'
   and 'cuda_csr' against 'ell', one without (MAX, attention: no kernel
   of its own) holds its fp32 forward to float64 on the card within
   1e-4 * max|logit| and its gradients within 1e-3 of each weight's
   largest (MAX outputs whose maxima differ between the precisions have
   their cotangent cut, and the uncut error is printed); then phase 6's
   10 epochs at lr 0.01 (SAGE-pool at 0.003; with --deep beside its
   lr-0.01 runs on the ELL max, the edge-list max and in float64,
   ungated), sum families
   on 'cuda' and 'cuda_csr', the others on 'cuda', with the counts
   zeroed just before each run: the train loss falls from epoch 4 to 9,
   each expected kernel ran (K4 on 'cuda', K3 on 'cuda_csr', K1 and K2
   for the fused chains of SGC, APPNP, GCNII and SAGE with GraphNorm) and
   no other; ``epoch_ms``, ``first_step_ms``, the launches a step, and
   with --deep phase 7's profile on 'cuda'.
13. the precomputed serving backend (roc_tpu_torch/serve/), each
   precompute with the counts zeroed just before and read just after:
   ``serve_akx``, an SGC 602-41 (k = 2, trained 20 epochs) at Reddit's
   shape on its 'akx' table: the precompute (the blocked host walk of
   core/streaming.py) with its wall and launches (K3 alone: the walk's
   norms are host row scales), with --deep one more walk's event span
   and pinned copies, the table bytes per mode, a 4,096-id sample against the same
   SGC on the full backend (fp32 within 1e-4, 'mixed' within 3e-2 of the
   logit scale), int8 exported through the default drift gate and fp8 behind
   the relaxed one, and each request size 20 times through
   Predictor.query and Server beside the full backend's;
   ``serve_table``, the GCN with phase 4's weights on the 'table'
   flavor in fp32 and 'mixed' (rows bit-equal to the full backend's,
   the same request times); ``serve_artifact``, the int8 akx and the
   fp32 table artifacts cold-loaded with load_predictor, rows bit-equal
   to the exporting predictor's; ``serve_invalidate`` at phase 12's
   arxiv shape (SGC 128-40): 8 undirected edges appended, rows
   recomputed, host and publish ms, the table against a rebuild on the
   mutated graph (1e-5), a batch pinned to the old version bit for bit,
   and int8 published while a thread serves batches pinned to the fp32
   version, each bit-exact.
14. the large-graph layouts (``layouts``, in a fresh process, as phase
   12): with --deep, races at Reddit's shape, the forward sum at F = 256 and 41 in
   fp32 and bf16 on K4 ('cuda'), K3 ('cuda_csr'), 'sectioned' (sub_w 8,
   int32 and uint16 ids) and 'flat_sum', each held to K4 (rtol 1e-5 in
   fp32, one bf16 ulp of the row's magnitude in bf16) with its host
   build seconds, event and device ms and K3/K4 launches a call (K4 on
   'cuda' alone, K3 on 'cuda_csr' alone, none on a layout); 'bdense' on
   planted communities in their own order (E cut to 23 M; min_fill 32,
   a 6 GiB A budget): the probe's dense share, the plans at group 1 and
   16, u4 packed and not, each held to K4 and timed beside it and
   'sectioned'; then a shuffled planted graph at the arxiv shape relabeled by
   lpa and bfs (seconds, dense shares; lpa must recover the oracle's);
   the 602-256-41 GCN on 'sectioned', 'flat_sum' and 'bdense' (3 parity
   steps against 'cuda', fp32 and 'mixed', with their steps' epoch_ms)
   and what 'auto' resolves to on this card (its row); ogbn-products'
   shape (symmetric, V = 2,449,029, E ~ 126 M, from the prep): GIN
   100-256-47 with 'auto' resolved to the card row's route, 'flat_sum'
   (parity) and 'cuda' (3 counted epochs), fp32 and 'mixed', GAT
   ('mixed', 'attn_flat8': 3 steps against 3 on 'ell'), SAGE-pool (fp32,
   'flat_sum''s max: its logits against 'ell''s, whose max cannot train
   at this shape in 80 GB, then 3 steps), and the peak memory.  The native host
   planners must have run for every layout built.  Its 'cuda' baselines
   are counted runs of the table.
15. the memory tier (``memory``, in a fresh process on the prep's
   datasets): K3 at the blocked walk's shape (a tile's first edge chunk
   over a 65,536-row source block, F = 602) against its plain version,
   timed with its library call and bound (the kernel table's
   ``walk_shapes``); the GCN with features='host' on 'cuda' in fp32 and
   'mixed': 3 parity steps at dropout 0 against features='hbm', 3 steps
   with prefetch 1 and 0 to the same bits, 10 epochs (K1, the masked K1,
   K2 and K4 ran; the loss falls) beside 10 on 'hbm', with epoch_ms,
   overlap_frac (the host's view), the staging waits, the pinned H2D
   rate, the peak and the modeled bytes, and with --deep one profiled
   steady step's device overlap (the share of H2D copy time under a
   kernel); the SGC 602-41 with features='host' (the trainer's walk
   launches K3 alone; with --deep the walk profiled: wall, device ms,
   the copies' share; 3 parity steps against 'hbm'); remat none, full and
   save_aggregates on the GCN (fp32, 'mixed') and on GIN 100-256-47 at
   the products shape (3 steps at dropout 0.5: weights within 1e-5 of
   none's, epoch_ms and peak each; 'full' recomputes a layer at a time,
   and GIN's peak under it must fall below none's); memory='auto' at Reddit's shape
   with the detected budget (gather/hbm) and with the remat and host
   plans' own estimates as budgets (those plans), 3 steps each, modeled
   beside measured peak; and the drills at the arxiv shape
   (features='host', dropout 0): staging_io:2 under train_with_recovery
   (one retry, the uninterrupted run's bits), stall_compile:0 with
   ROC_TPU_STALL_TIMEOUT_S (a StallFailure, then the restart finishes).
   Every run counted.
16. the rest of the partitioned trainer (``dist_ring``, in a fresh
   process on the prep's Reddit-shape dataset, the GCN 602-256-41 at full
   width from phase 5's weights, dropout 0): two gloo ranks on this card
   (NCCL takes one rank per card; gloo stages the transfers through the
   host), each holding one part: the ring halo (parallel/ring.py) in fp32,
   3 steps with K3 at every hop (hops x aggregations x steps launches, no
   pre-pass; K1, the masked K1 and K2 around it), each pair's row ranges
   ending at its real edges (no padding read) and K3 at each hop's shape
   held to its plain version with its times; the overlap off (the same
   bits); the gather through 'auto' on the same split (the card's row,
   K4; the split the numpy cost model's; the ring's losses within
   PARITY_RTOL and logits within PREDICT_TOL); 'mixed' ring against
   gather; memory='auto' under the gather plans (the ring plan, 3 steps);
   a forced repartition (the objectives within PARITY_RTOL of the run
   that never repartitions, the weights within the partitioned tests'
   rtol 2e-4, atol 2e-5); 'sectioned', 'flat_sum' and 'bdense' at the arxiv shape
   (planted communities) against 'cuda', 3 steps each; then four ranks:
   each one's peak on the ring and on the gather beside core/memory.py's
   modeled bytes.  Every path counted; its wall time printed.  The times
   of ranks sharing one card are a layout check, not a speed number.
17. partition-local loading, the ``(parts, model)`` mesh and its
   multi-writer checkpoint (``dist_mesh``, a child like 16, on the prep's
   Reddit-shape dataset, the GCN 602-256-41 from phase 5's weights,
   dropout 0, 3 steps): the dataset written in the reference layout with
   the port's ``save_dataset`` (``.add_self_edge.lux``, ``.feats.bin``,
   ``.label``, ``.mask``; the native writer's and reader's calls, the
   native whole read and ``load_lux_rows`` of one part equal to the
   arrays); two gloo ranks each building its part from a ``FileSource``
   (``parallel/multihost.py shard_dataset_local`` under the cost split:
   the bytes read from the ``.lux`` columns and ``.feats.bin`` equal to
   its part's share, the tables' sha256 equal to ``shard_dataset``'s from
   the whole Dataset, 3 counted steps on 'cuda' bit-equal to phase 16's
   P = 2 gather run, the host peak RSS beside phase 16's ranks'); then
   four ranks on the 2x2 mesh from the FileSource, the gather and the
   ring in fp32 and 'mixed' (objectives within PARITY_RTOL of phase 16's
   1-D runs, bit-equality printed; every param and Adam moment of its
   ``model_shard_spec`` slice shape; each rank's peak GPU memory; K1, the
   masked K1, K2 and K4 or K3 counted on every rank), the fp32 gather run
   saving a checkpoint after 2 steps with two writers (the manifest lists
   2 shard files), restored into a fresh 2x2 trainer (its next step the
   uninterrupted run's, bit for bit) and into 1-D trainers of two parts
   (the saved weights); each 2x2 rank's live replication ledger (role,
   shape, split, bytes; analysis/sharding_lint.py ``rank_ledgers``)
   beside the modeled ledger of the same shape (``dist_mesh_ledger``).
   Its wall time printed.  Ranks sharing one card
   over gloo: a layout check, not a speed number.
18. the replica fleet (``fleet``, a child like 14, replicas on card 0):
   the SGC 602-41 at Reddit's shape on 'akx' (phase 13's trained
   weights) exported with ``--shards 2`` in fp32 and int8, the GCN
   602-256-41 on 'table' (phase 4's weights) the same (K3 in the walk,
   K1, K4 and K2 in the forward, counted); a ``Router(sharded=True)``
   on each, its replicas' table budget 0.6 of the full table: a sample
   and a batch across the seam against the exporting predictor ('table'
   bit-equal, 'akx' within 1e-5 of the logit scale, the bit-equal share
   printed), each request size 20 times through the router beside the
   in-process Server on the whole table, the router's stats; the whole
   table refused under that budget (exit 3 before ``ready``); at the
   arxiv shape (SGC 128-40), the sharded refresh across the seam in this
   process and the four serve drills (``replica_sigkill:2:1``,
   ``replica_stall:2:0``, ``serve_io:1:0``, ``table_swap_mid_query:1:0``)
   each on its own 2-replica fleet, a replica drained by SIGTERM, an SLO
   armed on one router; the merged trace (:func:`fleet_traces`): the
   router process, the sharded fp32 'akx' fleet's replicas and the
   ``replica_sigkill`` fleet's write their events, each fleet's files
   merged by ``python -m roc_tpu_torch.timeline`` (one lane a process,
   the lanes' skew, ``--request`` on a request across the seam on warm
   replicas joining the router's span and a microbatch span on each
   replica, and on a
   requeued request the failover marker, the dead replica's fault
   marker and the survivor's span), and per request size the medians of
   the router span, the replica microbatch span and the gap between
   them, printed; its wall time printed.  Each replica runs every
   bucket before ``ready`` (serve/predictor.py ``Predictor.warm``): its
   warm report, which rides on the ready line, is printed and must show
   every bucket and no failure; each bucket's first request through each
   router is timed before any other and printed beside its steady median
   (``fleet_first_request``).

19. the chunked edge-list routes (``routes``, a child like 18, on the
   prep's datasets): the GCN 602-256-41 at Reddit's shape from
   phase 5's weights, dropout 0, fp32, 2 steps each on 'cuda'
   (head_chunk 0), 'blocked' and 'scan' (objectives within 1e-4 of
   'cuda''s, no kernel launched, each run's step ms and the card's peak)
   and on 'auto' with head_chunk 65536 (K1, K2, K4; within 1e-5); the
   run telemetry (:func:`telemetry`): the same GCN from the same weights,
   dropout 0.5, 6 epochs with an eval every 5, in fp32 and 'mixed', each
   with telemetry on (events, ``metrics_path``, and on fp32
   ``profile_dir``) and off (the bare step slots): the manifest (the
   card, 'cuda', the modeled bytes), the first step's ``compile`` event
   (its kernel FLOPs equal to the wrappers' launches at their shapes,
   the whole within 10 % of :func:`gcn_step_flops`; the peak and the
   memory model's ratio printed), the eval record's ``tflops_per_s`` and
   ``mfu`` in (0, 1], every objective bit-equal on and off, the trace's
   ``roc_`` ranges, phases and device kernels, and ``python -m
   roc_tpu_torch.report`` on the files; the CLI on a 16,384-row file set
   in the reference's format, 3 epochs with ``--checkpoint`` and
   ``--events --metrics --profile-dir`` (the report on its files), again
   with ``--events`` alone (``epoch_ms`` side by side), then ``--resume
   --eval-only --save-logits --reorder bfs`` (the logits in the original
   order within 1e-4 of ``Trainer.predict`` on the unreordered graph);
   SAGE-pool 100-256-47 at the products shape on 'ell' (the checkpointed
   ELL max), 2 steps in 'mixed', its peak.

20. prewarm (``prewarm``, a child like 19, beside it, in fresh temporary
   build caches): each kernel's first and second launch in the child
   (lazy module loading loads a kernel at its first launch); ``python -m
   roc_tpu_torch.prewarm --config all`` cold (exactly one library build,
   its seconds; the rigs of more ranks than one card skipped) and again
   in a second process, all warm with no new file (each process's wall
   printed; every rig's enumerated kernel instances equal to its
   launched ones); ``warm_trainer`` on phase 6's GCN 602-256-41 at
   Reddit's shape on 'cuda', dropout 0.5, in fp32 and 'mixed': the
   enumerated instances equal the launched ones (K1, the masked K1, K2
   and K4 at F = 256 and 41), the params and Adam state bit-equal after
   the warm, the next step's objective bit-equal to an unwarmed twin's
   (warm and steps counted); a truncated library in a third cache
   rebuilt (cold, never the plain versions) and K1-K4 then held to
   their plain versions as in phase 3.

21. lint (``lint``, a child like 20, beside 17, 19 and 20): the GCN
   602-256-41 at Reddit's shape from phase 5's weights, dropout 0, on
   'cuda' in fp32 and 'mixed' and on 'cuda_csr' in 'mixed': one train
   step and one eval step (its device work, ``eval_sums``) recorded by
   analysis/step_trace.py through the program-space candidates'
   ``run``, between two unrecorded train steps (every objective bit for
   bit the same); the recording's kernel entries equal the instances
   launched around it (the backward's from the autograd thread
   included) and the enumerated ones (K1, the masked K1, K2 and K4 on
   'cuda', K3 and its pre-pass on 'cuda_csr'); the jaxpr and HLO rules at
   the card's V * F, every finding printed and each held to the port's
   baseline; ``torch.cuda.set_sync_debug_mode('warn')`` over each
   recorded step warns as often as ``jaxpr-host-callback`` finds syncs,
   and over the whole ``evaluate`` (its metric fetch) too; printed, not
   gated: the recorded bytes beside the memory model's, and the step's
   wall time recorded and not.  Counted.

22. sentinel (``sentinel``, in phase 19's child right after its
   telemetry runs; no GPU work of its own): one round file per dtype in
   the bench headline shape, whose ``value`` is that dtype's
   telemetry-off steady ``epoch_ms`` on this card, and ``python -m
   roc_tpu_torch.sentinel --json --metrics <the on-run's metrics.jsonl>
   --dtype <mode>`` over them: exit 0, ``step_time_ms`` ok under the
   small-sample rule, ``n`` the rounds of that dtype alone, ``current``'s
   ``step_ms`` the on-run record's ``epoch_ms`` and its ``compile_s`` the
   record's ``first_step_ms`` / 1e3 (the card's first step, the kernels'
   first launches included); over a history of one round per dtype at
   half its ``epoch_ms`` (a 2x regression by construction): exit 1,
   ``regressed == ["step_time_ms"]``; the plain script
   ``roc_tpu_torch/obs/sentinel.py`` with torch blocked gives the same
   payloads; ``bench_verdict`` in process is ok.

23. data (``data``, in this process): beside phase 12's child, the
   host's part: the port's converter run as a user runs it, ``python -m
   roc_tpu_torch.convert_dataset``, on cora-synth and karate, each
   written file's sha256 equal to :data:`CONVERTED_SHA256` (the JAX
   script's bytes); then, once the prep has written it, a DGL-layout
   pair at Reddit's shape written from the prep's dataset, one direction
   of each edge with every seventh repeated and no self edge, converted
   with ``--no-csv``: the loaded graph equal to the prep's (the
   converter symmetrises, dedupes and adds the self edges back), the
   features, labels and mask to the dataset's; the converter's wall and
   peak RSS.  After the child has ended, so that no time of either
   shares the card: the port's CLI in this process on the card,
   each run with the counts zeroed just before and read just after:
   BASELINE.md config 1 (:data:`CONFIG1`, the 2-layer GCN 1433-16-7,
   scripts/cora_run.sh's flags) in fp32 and in 'mixed', each to test
   and val accuracy >= 85 %, and the karate club (:data:`KARATE`) to
   test accuracy >= 80 %; each with ``--impl auto`` resolved to
   'cuda', the manifest's platform 'gpu', K4, K1, the masked K1 and K2
   launched in the mode's dtype and no plain version standing in; the
   accuracies, steady ``epoch_ms`` and wall printed beside the card.

``python3 chip_smoke.py --first-gather [out.json]`` (:func:`first_gather`,
not in the default run) takes a small sharded fleet's first requests
apart: in process through ``Server``, through a router, the replicas'
spans of the first gathered request.

``python3 chip_smoke.py --attention-race [out.json]`` runs only the race
behind core/ell.py ``CARD_ROWS``'s attention entry: GAT 100-256-47 at
the products shape on 'attn_flat8', 'ell' and 'cuda', fp32 and 'mixed',
3 steps each (timed work, kept out of the default run).

Prints one JSON line per phase, the kernel table line
``{"kernels": [...]}`` (one row per kernel and dtype, e.g.
``ell_aggregate[bf16]``, K1's masked form as ``indegree_norm_masked``;
launches counted over the serve, train, dist, recovery, zoo, data,
precompute, layouts, memory, ring, mesh, fleet, routes, prewarm and lint
slices of that dtype; the F = 128 checks as each
row's ``zoo_shapes``, the F = 602 ones as ``akx_shapes`` (K1, K2 and K4
at the SGC's raw width), K3's walk check as ``walk_shapes`` and its ring
hops as ``ring_shapes``), the card line, and as the last line
``{"ok": true, "device": {...}}``.  Imports no JAX.
"""

import collections
import contextlib
import dataclasses
import functools
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict

import numpy as np

V = 232_965          # Reddit's vertex count
# Reddit's average degree; the synthetic graph has E = 111,689,429 after
# dedupe, self edges included
AVG_DEGREE = 493
LAYERS = [602, 256, 41]
SEED = 0
# the reference's Reddit run (example_run.sh): lr, weight decay, lr decay
TRAIN = dict(learning_rate=0.01, weight_decay=1e-4, decay_rate=0.97)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM
FP32_FLOPS = 67e12           # H100 SXM, fp32 outside the tensor cores
# the kernels of the path, their sources and the TPU kernels they replace
KERNELS = {
    "indegree_norm": ("roc_tpu_torch/kernels/csrc/graphnorm.cu",
                      "roc_tpu/kernels/graphnorm.py:60"),
    # K1's relu-masked form, the fused backward's pre-scale
    "indegree_norm_masked": ("roc_tpu_torch/kernels/csrc/graphnorm.cu",
                             "roc_tpu/kernels/graphnorm.py:60"),
    "scale_act": ("roc_tpu_torch/kernels/csrc/graphnorm.cu",
                  "roc_tpu/kernels/graphnorm.py:103"),
    "csr_spmm": ("roc_tpu_torch/kernels/csrc/spmm.cu",
                 "roc_tpu/kernels/spmm.py:83"),
    "ell_aggregate": ("roc_tpu_torch/kernels/csrc/ell_spmm.cu",
                      "roc_tpu/kernels/ell_spmm.py:196"),
}
# the launch counters' dtype keys (kernels/_build.py DTYPE_SUFFIX)
F32, BF16 = "f32", "bf16"
# The sha256 of each file ``python -m roc_tpu_torch.convert_dataset
# --dataset NAME --out PREFIX`` writes for the two datasets made without
# raw files.  The JAX package's scripts/convert_dataset.py writes these
# bytes (tests/test_torch_convert_dataset.py holds the constants to its
# output), so the data phase holds this machine's conversion to it.
CONVERTED_SHA256 = {
    "cora-synth": {
        ".add_self_edge.lux":
            "216e442a1b78ae173df63aacba087af62fb1d3d0cba99d875a6034756e545636",
        ".feats.bin":
            "ae6127b087a92c7cd4148580b4db3aab458d4516694817f718594accdc62008d",
        ".feats.csv":
            "cf1dea3682317e6c6bc70ca18d962a4eee6f6d6e9ef8f0ce0e938d66162b9263",
        ".label":
            "fd7b79c121b00da7a39fd5e7c5b592fa90d7b98d1166b7119e89d60b8d96177f",
        ".mask":
            "7f220936f303e5cfab122359dfde60bf46f8068d6c24284eaeb4b45035c2715d"},
    "karate": {
        ".add_self_edge.lux":
            "83ca75734ad228c5ce9836051b77ccd3ae7971060d5ec410386468efd5807cf4",
        ".feats.bin":
            "460a2e8dd4dbfef121cf8d2865bea7289ccbaaff1be560f8b011ba3dc4d32e7f",
        ".feats.csv":
            "b413ced7fd6820ec7baa06155fdc16e84c89c265f29824f4c3a822b0d770314c",
        ".label":
            "de3400591c6600bf6a2228d5b8f113bc4e5fc55bebafad98a892b6ad045eee9f",
        ".mask":
            "b18ef5706071915a4b140a416d466a7ba959d2dfcb471d2073ceff83acae5364"}}
# BASELINE.md config 1, the 2-layer GCN 1433-16-7 on Cora with
# scripts/cora_run.sh's flags, and its floor on test and val accuracy
# (%), the JAX gate's (tests/test_dataset_convert.py
# test_cora_accuracy_gate)
CONFIG1 = ["-layers", "1433-16-7", "-lr", "0.01", "-decay", "5e-4",
           "-dropout", "0.5", "-e", "200", "--eval-every", "50"]
CONFIG1_FLOOR = 85.0
# the karate club from its two labelled leaders, and its floor on test
# accuracy (%; tests/test_dataset_convert.py
# test_karate_real_data_cli_convergence_gate)
KARATE = ["-layers", "34-16-2", "-lr", "0.02", "-decay", "5e-4",
          "-dropout", "0.0", "-e", "150", "--eval-every", "150"]
KARATE_FLOOR = 80.0
# The timed work that gates nothing runs only with ``--deep`` (the
# children read it from CHIP_SMOKE_DEEP): the slice-width races' timings
# (phase 3, K3 at the walk's shape), the step profiles past phase 7's,
# the recovery's guard and snapshot rounds and save timings, the zoo's
# profiles and lr witness, the walk's profiles, the layouts' races and
# the block-dense race.  Every path, check and counted run stays in the
# default run, which must end well inside a 1,200 s limit.
DEEP = os.environ.get("CHIP_SMOKE_DEEP") == "1"
# ``--old DIR``: with ``--deep``, the gather races (:func:`gather_races`)
# also time the kernels of the checkout DIR (an earlier commit) in turns
OTHER_TREE = None


# the process's start, for the elapsed seconds of each phase line
_T0 = time.perf_counter()


def log(obj):
    """One JSON line; a phase line also carries ``t_s``, the seconds since
    this process started (a child's own)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, n, warm=1):
    """Mean ms per call over ``n`` calls (CUDA events, after warm-up)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(torch, fn, n):
    """Device ms per call: the time of every kernel that ``n`` calls of
    ``fn`` launch (after a warm call), summed by torch.profiler, over
    ``n``; None where the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / n if us > 0 else None


def bound_ms(nbytes, nops):
    """The card's least time: the larger of bytes over the memory rate
    and operations (kernels/_build.py ``kernel_ops``, the count the
    first-step observer's tally uses) over the fp32 rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = nops / FP32_FLOPS * 1e3
    return max(tb, to), ("bytes" if tb >= to else "operations")


def close_enough(torch, got, want, rtol, atol):
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    return ok, float(err.max()) if err.numel() else 0.0


def bf16_row_ulp(torch, want):
    """One bf16 ulp of each row's magnitude max|row| (0 for a zero row),
    [rows, 1]: a bf16 sum is its fp32 sum rounded once, and two fp32
    sums a few fp32 ulps apart (another order) round to the same bf16
    value or to neighbours."""
    m = want.float().abs().amax(dim=1, keepdim=True)
    _, e = torch.frexp(m)
    return torch.where(m > 0, torch.ldexp(torch.ones_like(m), e - 8),
                       torch.zeros_like(m))


def within_row_ulp(torch, got, want):
    """``(ok, max_abs_err)``: every element within one bf16 ulp of its
    row's magnitude."""
    err = (got.float() - want.float()).abs()
    ok = bool((err <= bf16_row_ulp(torch, want)).all())
    return ok, float(err.max()) if err.numel() else 0.0


def sum_check(torch, got, want):
    """A neighbour sum against its plain version: fp32 within rtol 1e-5,
    atol 1e-5 * max|row| (another summation order); bf16 within one bf16
    ulp of the row's magnitude."""
    if want.dtype == torch.bfloat16:
        return within_row_ulp(torch, got, want)
    return close_enough(torch, got, want, 1e-5,
                        1e-5 * float(want.abs().max()))


def ragged_checks(torch, dev):
    """Small ragged case: unaligned V, a 2048-wide hub row (1500 edges,
    spanning several 512-edge chunks of the edge list), rows of degree 0,
    F that is and is not a multiple of 4; K3 and K4 at every slice
    width, each launched twice for equal bits, and K3's row_ptr pre-pass
    against the graph's own row_ptr."""
    from roc_tpu_torch.core.ell import ell_from_graph
    from roc_tpu_torch.core.graph import from_edge_list
    from roc_tpu_torch.core.partition import padded_edge_list
    from roc_tpu_torch.kernels import ell_spmm, graphnorm, slicing, spmm
    rng = np.random.RandomState(1)
    n = 1003
    src = np.concatenate([rng.randint(0, n, 9000), rng.randint(0, n, 1500)])
    dst = np.concatenate([rng.randint(0, n, 9000), np.full(1500, 1)])
    keep = dst != 2
    g = from_edge_list(src[keep], dst[keep], n)
    t = ell_from_graph(g.row_ptr, g.col_idx, n)
    idx = tuple(torch.from_numpy(a[0]).to(dev) for a in t.idx)
    rid = tuple(torch.from_numpy(a[0]).to(dev) for a in t.row_id)
    deg = torch.from_numpy(g.in_degree).to(dev)
    esrc, edst = (torch.from_numpy(a).to(dev)
                  for a in padded_edge_list(g, multiple=512))
    # the pre-pass: the graph's row_ptr, the padding edges (on the last
    # row) ending that row's range at Ep
    want_ptr = g.row_ptr.copy()
    want_ptr[-1] = esrc.numel()
    assert np.array_equal(spmm.csr_row_ptr(edst, n).cpu().numpy(), want_ptr)
    cases = ((37, torch.float32), (36, torch.float32),
             (37, torch.bfloat16), (40, torch.bfloat16))
    for F, dt in cases:
        x = torch.from_numpy(rng.randn(n, F).astype(np.float32)).to(dev, dt)
        s = torch.from_numpy(rng.rand(n).astype(np.float32)).to(dev)
        assert torch.equal(graphnorm.indegree_norm(x, deg),
                           graphnorm.indegree_norm_plain(x, deg)), F
        for act in ("none", "relu"):
            assert torch.equal(graphnorm.scale_act(x, s, act),
                               graphnorm.scale_act_plain(x, s, act)), F
        # K4 and K3 at every slice width (sum_check: another summation
        # order); the degree-0 row is 0; no atomics, so two launches give
        # the same bits
        for name, kern, want in (
                ("ell_aggregate",
                 lambda S: ell_spmm.ell_aggregate(x, idx, rid, n,
                                                  slice_cols=S),
                 ell_spmm.ell_aggregate_plain(x, idx, rid, n)),
                ("csr_spmm",
                 lambda S: spmm.csr_spmm(x, esrc, edst, n, slice_cols=S),
                 spmm.csr_spmm_plain(x, esrc, edst, n))):
            for S in slicing.SLICE_COLS:
                got = kern(S)
                ok, err = sum_check(torch, got, want)
                assert ok and not got[2].any(), (name, F, dt, S, err)
                assert torch.equal(got, kern(S)), (name, F, dt, S)
    torch.cuda.synchronize()
    return {"V": n, "widths": list(t.widths), "edges_padded":
            int(esrc.numel()),
            "cases": [[F, str(dt).split(".")[-1]] for F, dt in cases],
            "slice_cols": list(slicing.SLICE_COLS), "ok": True}


def kernel_checks(torch, dev, gctx, adj, num_edges, esrc, edst, dtype,
                  widths=((256, "relu"), (41, "none")), with_csr=True):
    """Each kernel in ``dtype`` against its plain version at the shapes
    the forward and backward give it, with times: per ``(F, act)`` of
    ``widths``, K1, K2 with ``act`` (and the masked K1 where ``act`` is
    relu), K4 and (``with_csr``) K3 on ``gctx.num_rows`` rows of width
    F.  ``adj`` is
    the graph as a sparse CSR tensor, the input of K3's and K4's library
    yardstick ``torch.sparse.mm``; ``esrc``/``edst`` the padded edge list
    K3 reads.  K1 and K2 must be bit-equal; K3 and K4 pass
    :func:`sum_check`; every kernel gives the same bits on a second
    launch.  Returns the per-kernel table entries."""
    from roc_tpu_torch.kernels import ell_spmm, graphnorm, spmm
    from roc_tpu_torch.kernels._build import kernel_ops
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    bf16 = dtype == torch.bfloat16
    esize = 2 if bf16 else 4
    V = gctx.num_rows      # the graph's rows (the module's V by default)
    deg, d = gctx.in_degree, gctx.inv_sqrt_deg
    d_lib = d.to(dtype)   # the library call's scale, in x's dtype
    idx, rid = gctx.ell_idx, gctx.ell_row_id
    idx_entries = sum(int(a.numel()) for a in idx)
    bucket_rows = sum(int(a.numel()) for a in rid)
    padded_edges = int(esrc.numel())
    entries = {name: dict(source=src, replaces=rep)
               for name, (src, rep) in KERNELS.items()}
    for e in entries.values():
        e.update(shapes=[], ms=0.0, device_ms=0.0, plain_ms=0.0,
                 bound_ms=0.0, library_ms=0.0, max_abs_err=0.0, _tb=0.0,
                 _to=0.0)

    def library_call(fn):
        """``fn`` if PyTorch on this card runs it, else None (then the
        kernel's library_ms is null and the reason is logged)."""
        try:
            fn()
            torch.cuda.synchronize()
            return fn
        except RuntimeError as err:
            log({"phase": "kernel", "library_unsupported": str(err)[:300],
                 "dtype": str(dtype)})
            return None

    def add(name, shape, check, fn, plain, lib, nbytes, nops, n,
            lib_call="torch.sparse.mm(adj, x)", copy=None):
        """``copy``: a copy of the same bytes (``out.copy_(x)``), whose
        device time is the streaming rate PyTorch itself reaches."""
        ok, err = check
        ms = time_ms(torch, fn, n)
        dms = device_ms(torch, fn, n)
        pms = time_ms(torch, plain, max(1, n // 4))
        lms = time_ms(torch, lib, n) if lib is not None else None
        ldms = device_ms(torch, lib, n) if lib is not None else None
        b, by = bound_ms(nbytes, nops)
        below = {}
        if dms is not None and dms < b:
            # faster than the card can move the bytes from HBM: the
            # repeats found the working set in L2, or the profiler lost
            # records; not a device time of this work
            below, dms = {"device_ms_below_bound": dms}, None
        row = dict(kernel=name, dtype=str(dtype), shape=shape,
                   max_abs_err=err, ms=ms, device_ms=dms, plain_ms=pms,
                   library_ms=lms, library_device_ms=ldms,
                   library_call=lib_call, bound_ms=b, bound_by=by, ok=ok,
                   **below)
        if copy is not None:
            row["copy_device_ms"] = device_ms(torch, copy, n)
        log({"phase": "kernel", **row})
        if not ok:
            raise AssertionError(f"{name} {dtype} {shape} disagrees with "
                                 f"its plain version: max_abs_err {err}")
        e = entries[name]
        e["shapes"].append(row)
        e["ms"] += ms
        e["device_ms"] = (None if dms is None or e["device_ms"] is None
                          else e["device_ms"] + dms)
        e["plain_ms"] += pms
        e["library_ms"] = (None if lms is None or e["library_ms"] is None
                           else e["library_ms"] + lms)
        e["bound_ms"] += b
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["_tb"] += nbytes
        e["_to"] += nops

    def exact(got, want):
        return bool(torch.equal(got, want)), float(
            (got.float() - want.float()).abs().max())

    def twice(kern):
        """The kernel's result, held to the same bits on a second
        launch."""
        got = kern()
        if not torch.equal(got, kern()):
            raise AssertionError(f"two launches differ in {dtype}")
        return got

    # K3's row_ptr pre-pass against its plain version (torch.searchsorted
    # on the card): exact; timed alone here, inside K3's time below
    if not bf16:
        got = spmm.csr_row_ptr(edst, V)
        if not torch.equal(got, spmm.csr_row_ptr_plain(edst, V)):
            raise AssertionError("csr_row_ptr disagrees with searchsorted")
        entries["csr_spmm"]["row_ptr_ms"] = time_ms(
            torch, lambda: spmm.csr_row_ptr(edst, V), 20)
        del got

    # the forward's shapes: K1 and K2 at F = 256 (layer 1, K2 with the
    # folded relu) and F = 41 (layer 2, no activation); K3 and K4 at both
    # widths over the real edge list and buckets.  The backward runs the
    # same shapes (K2 with no activation), and at F = 256 the masked K1
    # on the cotangent and the relu output.
    for F, act in widths:
        x = torch.randn((V, F), generator=gen, device=dev).to(dtype)
        vf = V * F
        buf = torch.empty_like(x)
        # K1: 0 ulp (same fp32 operations and rounding as the plain
        # version)
        add("indegree_norm", [V, F],
            exact(twice(lambda: graphnorm.indegree_norm(x, deg)),
                  graphnorm.indegree_norm_plain(x, deg)),
            lambda: graphnorm.indegree_norm(x, deg),
            lambda: graphnorm.indegree_norm_plain(x, deg),
            lambda: x * d_lib[:, None],
            2 * esize * vf + 4 * V, kernel_ops("indegree_norm", V, 0, F), 50,
            lib_call="x * d[:, None]",
            copy=lambda: buf.copy_(x))
        # K2: 0 ulp
        lib = ((lambda: torch.relu(x * d_lib[:, None])) if act == "relu"
               else (lambda: x * d_lib[:, None]))
        add("scale_act", [V, F, act],
            exact(twice(lambda: graphnorm.scale_act(x, d, act)),
                  graphnorm.scale_act_plain(x, d, act)),
            lambda: graphnorm.scale_act(x, d, act),
            lambda: graphnorm.scale_act_plain(x, d, act), lib,
            2 * esize * vf + 4 * V, kernel_ops("scale_act", V, 0, F), 50,
            lib_call=("relu(x * d[:, None])" if act == "relu"
                      else "x * d[:, None]"), copy=lambda: buf.copy_(x))
        if act == "relu":
            # the masked K1 on a cotangent g and the relu output y: 0 ulp;
            # its yardstick is the chain of calls the backward ran before
            # it: mask, cast, multiply, then the scale
            g = torch.randn((V, F), generator=gen, device=dev).to(dtype)
            y = torch.relu(torch.randn((V, F), generator=gen,
                                       device=dev)).to(dtype)
            add("indegree_norm_masked", [V, F],
                exact(twice(lambda: graphnorm.indegree_norm(
                    g, deg, relu_out=y)),
                    graphnorm.indegree_norm_plain(g, deg, relu_out=y)),
                lambda: graphnorm.indegree_norm(g, deg, relu_out=y),
                lambda: graphnorm.indegree_norm_plain(g, deg, relu_out=y),
                lambda: (g * (y > 0).to(dtype)) * d_lib[:, None],
                3 * esize * vf + 4 * V,
                kernel_ops("indegree_norm_masked", V, 0, F), 50,
                lib_call="chain of calls: (g * (y > 0).to(dtype)) * "
                         "d[:, None]")
            del g, y
        del buf
        # K4: sum_check (another summation order)
        want = ell_spmm.ell_aggregate_plain(x, idx, rid, V)
        got = twice(lambda: ell_spmm.ell_aggregate(x, idx, rid, V))
        add("ell_aggregate", [V, F, list(a.shape[1] for a in idx),
                              "slice_cols="
                              f"{ell_spmm.default_slice_cols(F, dtype)}"],
            sum_check(torch, got, want),
            lambda: ell_spmm.ell_aggregate(x, idx, rid, V),
            lambda: ell_spmm.ell_aggregate_plain(x, idx, rid, V),
            library_call(lambda: torch.sparse.mm(adj, x)),
            2 * esize * vf + 4 * idx_entries + 4 * bucket_rows,
            kernel_ops("ell_aggregate", V, num_edges, F), 5)
        if not with_csr:
            del x, want, got
            continue
        # K3 over the padded edge list: the same check; bytes: feats and
        # out once, src and dst once
        want = spmm.csr_spmm_plain(x, esrc, edst, V)
        got = twice(lambda: spmm.csr_spmm(x, esrc, edst, V))
        add("csr_spmm", [V, F, padded_edges,
                         f"slice_cols={spmm.default_slice_cols(F, dtype)}"],
            sum_check(torch, got, want),
            lambda: spmm.csr_spmm(x, esrc, edst, V),
            lambda: spmm.csr_spmm_plain(x, esrc, edst, V),
            library_call(lambda: torch.sparse.mm(adj, x)),
            2 * esize * vf + 8 * padded_edges,
            kernel_ops("csr_spmm", V, num_edges, F), 5)
        del x, want, got
    for e in entries.values():
        e["bound_by"] = ("bytes" if e["_tb"] / HBM_BYTES_PER_S
                         >= e["_to"] / FP32_FLOPS else "operations")
        del e["_tb"], e["_to"]
    return entries


def race(torch, dev, gctx, num_edges, esrc, edst, dtype):
    """Every slice width of K4 and K3 in ``dtype`` at the layer widths
    F = 256 and F = 41 over the full graph, each held to the plain
    version and launched twice for equal bits; with ``--deep``
    (:data:`DEEP`) also timed in turns in one process: the
    plain version, each instance, each instance again in reverse order,
    the plain version again (``ms`` is the mean of an instance's two
    readings).  Each instance is first held to the plain version
    (:func:`sum_check`) and launched twice for equal bits.  Prints, per
    instance, the effective gather rate E * F * itemsize / ms and the
    HBM bytes the schedule needs over ms: feats once per launch (K4:
    once per bucket), out once, the ids once per slice (K4: the bucket
    tables; K3: edge_src and row_ptr; the pre-pass's searches are not
    counted); and the fastest instance, the wrappers' default, and the
    ties: the instances whose gap to the fastest is no more than the
    spread of their own or the fastest's two readings.  Returns the
    records."""
    from roc_tpu_torch.kernels import ell_spmm, slicing, spmm
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    esize = 2 if dtype == torch.bfloat16 else 4
    idx, rid = gctx.ell_idx, gctx.ell_row_id
    ell_ids = 4 * sum(int(a.numel()) for a in (*idx, *rid))
    csr_ids = 4 * int(esrc.numel()) + 8 * (V + 1)
    records = []
    for F in (256, 41):
        x = torch.randn((V, F), generator=gen, device=dev).to(dtype)
        fb = esize * V * F
        n = 5 if F > slicing.NARROW_F else 10
        for name, mod, kern, plain, feats_reads, ids_bytes in (
                ("ell_aggregate", ell_spmm,
                 lambda S: ell_spmm.ell_aggregate(x, idx, rid, V,
                                                  slice_cols=S),
                 lambda: ell_spmm.ell_aggregate_plain(x, idx, rid, V),
                 len(idx), ell_ids),
                ("csr_spmm", spmm,
                 lambda S: spmm.csr_spmm(x, esrc, edst, V, slice_cols=S),
                 lambda: spmm.csr_spmm_plain(x, esrc, edst, V),
                 1, csr_ids)):
            want = plain()
            inst = {}
            for S in slicing.SLICE_COLS:
                got = kern(S)
                ok, err = sum_check(torch, got, want)
                if not (ok and torch.equal(got, kern(S))):
                    raise AssertionError(f"{name} {dtype} F={F} "
                                         f"slice_cols={S}: max_abs_err "
                                         f"{err}, or two launches differ")
                slices = -(-F // S) if S else 1
                inst[S] = {"slice_cols": S, "max_abs_err": err,
                           "hbm_bytes": fb * feats_reads + fb
                           + ids_bytes * slices, "readings": []}
                del got
            del want
            if not DEEP:
                rec = {"phase": "race", "kernel": name, "dtype": str(dtype),
                       "F": F, "instances": list(inst.values()),
                       "timed": "with --deep"}
                log(rec)
                records.append(rec)
                continue
            plain_ms = [time_ms(torch, plain, 1)]
            for S in (*slicing.SLICE_COLS, *reversed(slicing.SLICE_COLS)):
                inst[S]["readings"].append(
                    time_ms(torch, lambda: kern(S), n))
            plain_ms.append(time_ms(torch, plain, 1))
            for r in inst.values():
                r["ms"] = sum(r["readings"]) / len(r["readings"])
                r["gather_tb_s"] = num_edges * F * esize / r["ms"] / 1e9
                r["hbm_tb_s"] = r["hbm_bytes"] / r["ms"] / 1e9
            fastest = min(inst, key=lambda S: inst[S]["ms"])

            def spread(S):
                return abs(inst[S]["readings"][0] - inst[S]["readings"][1])
            rec = {"phase": "race", "kernel": name, "dtype": str(dtype),
                   "F": F, "plain_ms": plain_ms,
                   "instances": list(inst.values()), "fastest": fastest,
                   "default": mod.default_slice_cols(F, dtype),
                   "ties": [S for S in inst if inst[S]["ms"]
                            - inst[fastest]["ms"]
                            <= max(spread(S), spread(fastest))]}
            log(rec)
            records.append(rec)
        del x
    torch.cuda.synchronize()
    return records


# The gather races (``--gather-race``, and with ``--deep`` after phase
# 3): the ceiling's one-bucket tables are CEILING_WIDTH ids wide, and its
# window pattern draws ids from the first CEILING_WINDOW_ROWS rows (128 KB
# of fp32 rows at F = 256, what one SM's L1 holds)
CEILING_WIDTH = 512
CEILING_WINDOW_ROWS = 128
# each timed reading of a race covers about this many ms of calls
RACE_READING_MS = 100.0


def _turns(torch, fns, n=None):
    """Times each callable of ``fns`` (a dict) in turns, forward then
    reversed, ``n`` calls a reading (None: enough for ~RACE_READING_MS
    each, from one warm call of the first): ``{key: [ms, ms]}``."""
    if n is None:
        one = time_ms(torch, next(iter(fns.values())), 1)
        n = max(2, min(50, int(RACE_READING_MS / max(one, 1e-3))))
    out = {k: [] for k in fns}
    for k in (*fns, *reversed(list(fns))):
        out[k].append(time_ms(torch, fns[k], n))
    return out


def other_gathers(root):
    """K3 and K4 as another checkout ``root`` (a ``git archive`` of an
    earlier commit) builds them: every ``csrc/*.cu`` of ``root`` compiled
    by nvcc with this tree's flags into a library of its own under
    ``root``, called through the same C entry points, and its wrappers'
    default slice widths read by a Python process in ``root`` (its
    package, not this one).  Returns ``{"ell": fn(x, idx, rid, V, S),
    "csr": fn(x, src, row_ptr, V, S), "default": fn(kernel, dtype,
    F)}``.  Its launches count nowhere."""
    import glob

    import torch
    from roc_tpu_torch.kernels import _build
    root = os.path.abspath(root)
    srcs = sorted(glob.glob(os.path.join(root, "roc_tpu_torch", "kernels",
                                         "csrc", "*.cu")))
    target = os.path.join(root, "libroc_kernels_other.so")
    _build._build(srcs, target)
    lib = _build._load(target)
    code = ("import json, torch\n"
            "from roc_tpu_torch.kernels import ell_spmm, spmm\n"
            "print(json.dumps({f'{k}/{d}/{F}': m.default_slice_cols("
            "F, getattr(torch, d)) for k, m in (('ell_aggregate', "
            "ell_spmm), ('csr_spmm', spmm)) for d in ('float32', "
            "'bfloat16') for F in (41, 128, 256, 602)}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=300,
                         check=True)
    defaults = json.loads(res.stdout.strip().splitlines()[-1])

    def sfx(x):
        return _build.DTYPE_SUFFIX[x.dtype]

    def ell(x, idx, rid, num_rows, S):
        fn = getattr(lib, f"roc_ell_aggregate_{sfx(x)}")
        out = x.new_zeros((num_rows, x.shape[1]))
        st = _build.stream_ptr(x.device)
        for i, r in zip(idx, rid):
            code = fn(x.data_ptr(), i.data_ptr(), r.data_ptr(),
                      out.data_ptr(), i.shape[0], i.shape[1], x.shape[0],
                      num_rows, x.shape[1], S, st)
            if code:
                raise RuntimeError(f"the other K4: CUDA error {code}")
        return out

    def csr(x, src, row_ptr, num_rows, S):
        fn = getattr(lib, f"roc_csr_spmm_{sfx(x)}")
        out = torch.empty((num_rows, x.shape[1]), dtype=x.dtype,
                          device=x.device)
        code = fn(x.data_ptr(), src.data_ptr(), row_ptr.data_ptr(),
                  out.data_ptr(), x.shape[0], num_rows, x.shape[1], S,
                  _build.stream_ptr(x.device))
        if code:
            raise RuntimeError(f"the other K3: CUDA error {code}")
        return out

    def default(kernel, dtype, F):
        return defaults[f"{kernel}/{str(dtype).split('.')[-1]}/{F}"]
    return {"ell": ell, "csr": csr, "default": default, "root": root}


def gather_ceiling(torch, other=None, F=256, S=32):
    """What K4 gathers at, by where its rows come from: K4 at F = 256
    fp32, slice S, over V rows of one synthetic bucket of CEILING_WIDTH
    ids, with three id patterns: ``sequential`` (row r's ids r * width +
    j mod V, consecutive: the rows sweep V in order, width times over,
    and one slice of them, V * S * 4 bytes, is what L2 holds, so after
    the first sweep they come from L2 too: not an HBM stream), ``random``
    (uniform over all V: Reddit's case, the slice's rows from L2) and
    ``window`` (uniform over the first CEILING_WINDOW_ROWS rows, which L1
    holds).  Each pattern's rate is E * F * 4 / ms (E = V * width); this
    tree's wrapper and, given ``other``
    (:func:`other_gathers`), the other tree's kernel are timed in turns.
    Each result's first 4,096 rows are held to the plain version.  Gates
    nothing: timed work."""
    from roc_tpu_torch.kernels import ell_spmm
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    W = CEILING_WIDTH
    E = V * W
    x = torch.randn((V, F), generator=gen, device=dev)
    rid = torch.arange(V, device=dev, dtype=torch.int32)
    pats = {
        "sequential": (torch.arange(E, device=dev) % V).to(torch.int32)
        .view(V, W),
        "random": torch.randint(0, V, (V, W), generator=gen, device=dev,
                                dtype=torch.int32),
        "window": torch.randint(0, CEILING_WINDOW_ROWS, (V, W),
                                generator=gen, device=dev,
                                dtype=torch.int32)}
    sides = {"this": lambda i: ell_spmm.ell_aggregate(x, (i,), (rid,), V,
                                                      slice_cols=S)}
    if other is not None:
        sides["other"] = lambda i: other["ell"](x, (i,), (rid,), V, S)
    fns = {}
    k = min(4096, V)
    for side, fn in sides.items():
        for pat, idx in pats.items():
            want = ell_spmm.ell_aggregate_plain(x, (idx[:k],), (rid[:k],),
                                                k)
            ok, err = sum_check(torch, fn(idx)[:k], want)
            if not ok:
                raise AssertionError(f"ceiling {side} {pat}: {err}")
            fns[f"{side}/{pat}"] = functools.partial(fn, idx)
    readings = _turns(torch, fns)
    rec = {"phase": "gather_ceiling", "F": F, "slice_cols": S, "V": V,
           "width": W, "edges": E, "gathered_gb": E * F * 4 / 1e9,
           "card": card_line(), "runs": {}}
    for k, r in readings.items():
        ms = sum(r) / len(r)
        rec["runs"][k] = {"ms": ms, "readings": r,
                          "gather_tb_s": E * F * 4 / ms / 1e9}
    log(rec)
    del pats, x
    torch.cuda.empty_cache()
    return rec


def _race_case(torch, label, kernel, x, new, old, want, lib, nbytes, nops,
               gathered, default):
    """One shape of :func:`gather_races`: this tree's kernel at every
    slice width (``new(S)``; keys ``new/S``) and, where ``old`` is given
    (``(fn(S), its default S)``), the other tree's at every width (keys
    ``old/S``), each held to ``want`` (:func:`sum_check`) and launched
    twice for equal bits, then timed in turns; ``lib`` (or None) is the
    library call, timed once; ``default`` is the key of the wrappers'
    default instance.  Prints and returns the record: per instance its
    ms, spread and gather rate (``gathered`` bytes over ms), the fastest
    of each tree, the ties (gap no more than either's spread), this
    tree's default against the other's."""
    from roc_tpu_torch.kernels import slicing
    fns = {}
    errs = {}
    cands = [(f"new/{S}", functools.partial(new, S))
             for S in slicing.SLICE_COLS]
    if old is not None:
        cands = [(f"old/{S}", functools.partial(old[0], S))
                 for S in slicing.SLICE_COLS] + cands
    for key, fn in cands:
        got = fn()
        ok, err = sum_check(torch, got, want)
        if not (ok and torch.equal(got, fn())):
            raise AssertionError(f"{label} {key}: max_abs_err {err}, or "
                                 "two launches differ")
        errs[key] = err
        fns[key] = fn
        del got
    readings = _turns(torch, fns)
    b, by = bound_ms(nbytes, nops)
    try:
        lib_ms = time_ms(torch, lib, 3) if lib is not None else None
    except RuntimeError:     # no such call for this dtype here
        lib_ms = None
    rec = {"phase": "gather_race", "case": label, "kernel": kernel,
           "dtype": str(x.dtype), "shape": list(x.shape),
           "gathered_gb": gathered / 1e9, "bound_ms": b, "bound_by": by,
           "library_ms": lib_ms, "default": default, "instances": {}}
    for k, r in readings.items():
        ms = sum(r) / len(r)
        rec["instances"][k] = {"ms": ms, "spread": abs(r[0] - r[1]),
                               "gather_tb_s": gathered / ms / 1e9,
                               "max_abs_err": errs[k]}
    inst = rec["instances"]
    new_keys = [k for k in inst if k.startswith("new/")]
    fastest = min(new_keys, key=lambda k: inst[k]["ms"])
    rec["fastest"] = fastest
    rec["ties"] = [k for k in new_keys if inst[k]["ms"] - inst[fastest]["ms"]
                   <= max(inst[k]["spread"], inst[fastest]["spread"])]
    d = inst[default]
    if old is not None:
        rec["old_default"] = f"old/{old[1]}"
        rec["old_fastest"] = min((k for k in inst if k.startswith("old/")),
                                 key=lambda k: inst[k]["ms"])
        o = inst[rec["old_default"]]
        rec["old_over_default"] = o["ms"] / d["ms"]
        rec["old_faster"] = (d["ms"] - o["ms"]
                             > max(d["spread"], o["spread"]))
    log(rec)
    return rec


def gather_races(torch, ds, gctx, other=None):
    """K3 and K4 at every shape of PERF.md's kernel table, each at every
    slice width, and with ``other`` (:func:`other_gathers`) against the
    other tree's kernels at every width, in turns (:func:`_race_case`):
    the ceiling (:func:`gather_ceiling`); Reddit's shape (``ds``, ``gctx``
    its ELL tables) at F = 256 and 41 and K4 at F = 602, in fp32 and
    bf16; the arxiv shape at F = 128; K3 at the
    blocked walk's first chunk (F = 602); K3 at the ring's first hop of
    part 0 of 2 (F = 256 and 41, both dtypes).  K3's main pass is timed
    over precomputed row ranges (the pre-pass is the same on both
    sides).  Gates nothing but the results: timed work."""
    from roc_tpu_torch.core.graph import synthetic_dataset
    from roc_tpu_torch.core.partition import (padded_edge_list,
                                              partition_col,
                                              partition_plan)
    from roc_tpu_torch.core.streaming import BLOCK_ROWS, build_tile_plans
    from roc_tpu_torch.kernels import ell_spmm, spmm
    from roc_tpu_torch.kernels._build import kernel_ops
    from roc_tpu_torch.parallel.ring import RING_MULTIPLE, ring_part_tables
    from roc_tpu_torch.train.trainer import make_graph_context
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    recs = [gather_ceiling(torch, other)]

    def ell_cases(tag, g, ctx, widths, dtypes):
        idx, rid = ctx.ell_idx, ctx.ell_row_id
        Vg, E = g.num_nodes, g.num_edges
        ids = 4 * sum(int(a.numel()) for a in (*idx, *rid))
        for dtype in dtypes:
            adj = torch.sparse_csr_tensor(
                torch.from_numpy(g.row_ptr).to(dev),
                torch.from_numpy(g.col_idx.astype(np.int64)).to(dev),
                torch.ones(E, device=dev, dtype=dtype), size=(Vg, Vg),
                check_invariants=False)
            es = 2 if dtype == torch.bfloat16 else 4
            for F in widths:
                x = torch.randn((Vg, F), generator=gen, device=dev).to(dtype)
                old = None if other is None else (
                    functools.partial(other["ell"], x, idx, rid, Vg),
                    other["default"]("ell_aggregate", dtype, F))
                recs.append(_race_case(
                    torch, f"{tag}/F={F}", "ell_aggregate", x,
                    lambda S, x=x: ell_spmm.ell_aggregate(
                        x, idx, rid, Vg, slice_cols=S), old,
                    ell_spmm.ell_aggregate_plain(x, idx, rid, Vg),
                    lambda x=x: torch.sparse.mm(adj, x),
                    2 * es * Vg * F + ids, kernel_ops("ell_aggregate", Vg,
                                                      E, F),
                    E * F * es,
                    f"new/{ell_spmm.default_slice_cols(F, dtype)}"))
                del x
            del adj
            torch.cuda.empty_cache()

    def csr_case(tag, x, src, row_ptr, num_rows, chunk, n_real, nbytes,
                 adj, want):
        F = x.shape[1]
        old = None if other is None else (
            functools.partial(other["csr"], x, src, row_ptr, num_rows),
            other["default"]("csr_spmm", x.dtype, F))
        es = x.element_size()
        recs.append(_race_case(
            torch, f"{tag}/F={F}", "csr_spmm", x,
            lambda S: spmm.csr_spmm(x, src, None, num_rows, chunk=chunk,
                                    slice_cols=S, row_ptr=row_ptr),
            old, want, (lambda: torch.sparse.mm(adj, x)) if adj is not None
            else None, nbytes, kernel_ops("csr_spmm", num_rows, n_real, F),
            n_real * F * es,
            f"new/{spmm.default_slice_cols(F, x.dtype)}"))

    def csr_cases(tag, g, widths, dtypes):
        Vg, E = g.num_nodes, g.num_edges
        esrc, edst = (torch.from_numpy(a).to(dev)
                      for a in padded_edge_list(g, multiple=512))
        rp = spmm.csr_row_ptr(edst, Vg)
        for dtype in dtypes:
            adj = torch.sparse_csr_tensor(
                torch.from_numpy(g.row_ptr).to(dev),
                torch.from_numpy(g.col_idx.astype(np.int64)).to(dev),
                torch.ones(E, device=dev, dtype=dtype), size=(Vg, Vg),
                check_invariants=False)
            es = 2 if dtype == torch.bfloat16 else 4
            for F in widths:
                x = torch.randn((Vg, F), generator=gen, device=dev).to(dtype)
                csr_case(tag, x, esrc, rp, Vg, 512, E,
                         2 * es * Vg * F + 8 * int(esrc.numel()), adj,
                         spmm.csr_spmm_plain(x, esrc, edst, Vg))
                del x
            del adj
            torch.cuda.empty_cache()
        del esrc, edst, rp

    both = (torch.float32, torch.bfloat16)
    g = ds.graph
    ell_cases("reddit", g, gctx, (256, 41), both)
    ell_cases("reddit", g, gctx, (LAYERS[0],), both)
    csr_cases("reddit", g, (256, 41), both)
    # the arxiv shape, the zoo's input width
    za = synthetic_dataset(ZOO_V, ZOO_DEGREE, in_dim=ZOO_LAYERS[0],
                           num_classes=ZOO_LAYERS[-1], seed=SEED,
                           name="arxiv_shape")
    zctx = make_graph_context(za, "cuda", symmetric=True)
    ell_cases("arxiv", za.graph, zctx, (ZOO_LAYERS[0],), both)
    del zctx
    csr_cases("arxiv", za.graph, (ZOO_LAYERS[0],), both)
    del za
    # the blocked walk's first chunk (walk_k3_check's shape)
    t = build_tile_plans(g, BLOCK_ROWS)[0][0]
    src, dst, _, rows = next(iter(t.dev_chunks(WALK_EDGE_CHUNK, dev,
                                               cache=False)))
    block = torch.from_numpy(np.ascontiguousarray(
        ds.features[t.src_lo:t.src_lo + t.src_rows], dtype=np.float32)
    ).to(dev)
    real = src != t.src_rows
    n_real = int(real.sum())
    rp = spmm.csr_row_ptr(dst, rows)
    adj = torch.sparse_csr_tensor(
        torch.searchsorted(dst[real].contiguous(), torch.arange(
            rows + 1, device=dev, dtype=torch.int32)),
        src[real].long(), torch.ones(n_real, device=dev),
        size=(rows, t.src_rows), check_invariants=False)
    n_src = int(torch.unique(src[real]).numel())
    csr_case("walk", block, src, rp, rows, 1, n_real,
             4 * (n_src + rows) * LAYERS[0] + 8 * int(src.numel()), adj,
             spmm.csr_spmm_plain(block, src, dst, rows))
    del block, src, dst, adj, rp
    # the ring's first hop: part 0 of 2, pair 0
    plan = partition_plan(g.row_ptr, 2)
    tabs = ring_part_tables(plan, 0, partition_col(
        plan, lambda a, b: g.col_idx[a:b], 0))
    pn = plan.part_nodes
    n = int(tabs["real"][0])
    src = torch.from_numpy(tabs["src"][0]).to(dev)
    rp = torch.from_numpy(tabs["row_ptr"][0]).to(dev)
    dst = spmm.dst_from_row_ptr(rp, src.numel())
    for dtype in both:
        adj = torch.sparse_csr_tensor(rp, src[:n].long(), torch.ones(
            n, device=dev, dtype=dtype), size=(pn, pn),
            check_invariants=False)
        es = 2 if dtype == torch.bfloat16 else 4
        for F in (256, 41):
            x = torch.randn((pn, F), generator=gen, device=dev).to(dtype)
            csr_case("ring_hop", x, src, rp, pn, RING_MULTIPLE, n,
                     2 * pn * F * es + n * 4 + (pn + 1) * 8, adj,
                     spmm.csr_spmm_plain(x, src, dst, pn))
            del x
        del adj
    del src, rp, dst
    torch.cuda.empty_cache()
    return recs


def gather_race_main(out_path=None, other=None):
    """:func:`gather_races` alone on card 0, on the Reddit shape built
    here: ``python3 chip_smoke.py --gather-race [out.json] [--old
    DIR]``, DIR a checkout of another commit whose kernels race this
    tree's in turns.  Prints each kernel instance's registers, shared
    memory and spills (``ptxas``) first."""
    import torch
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    from roc_tpu_torch.train.trainer import make_graph_context
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    _build.library()
    print(card_line(), flush=True)
    log({"phase": "build", "seconds": _build.build_seconds,
         "ptxas": [ln.strip() for entry in _build.build_log
                   for ln in entry.splitlines() if "registers" in ln
                   or "spill" in ln or "Compiling entry" in ln]})
    old = other_gathers(other) if other else None
    t0 = time.perf_counter()
    ds = reddit_dataset()
    gctx = make_graph_context(ds, "cuda", symmetric=True)
    log({"phase": "gather_race_data", "seconds": time.perf_counter() - t0,
         "E": ds.graph.num_edges})
    recs = gather_races(torch, ds, gctx, old)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(recs, f)
    print(card_line(), flush=True)
    return recs


REQUEST_SIZES = (1, 8, 64, 512)
REPEATS = 20


def lat_stats(ms):
    """Median, p90 and max of a list of request times (ms)."""
    a = np.asarray(ms, dtype=np.float64)
    return {"n": int(a.size), "median_ms": float(np.median(a)),
            "p90_ms": float(np.percentile(a, 90)), "max_ms": float(a.max())}


def request_times(call, num_nodes, seed, sizes=REQUEST_SIZES,
                  reps=REPEATS, keep=None, first=None):
    """Each request size ``reps`` times through ``call(ids)`` (random
    ids, id 0 first), one after another: per size the stats of
    :func:`lat_stats`, every time in order (``all_ms``) and, for a
    Server, each request's dispatch wall (``dispatch_ms``).  ``keep`` (a
    list) receives each ``(ids, rows)``.  ``first(n, ids)``, where given,
    may take one more request of size ``n`` before the ``reps`` timed
    ones, on its own path: it returns ``(rows, record)`` (kept under
    ``first``, its wall under ``first_ms``, outside the stats) or None
    to take none."""
    rng = np.random.RandomState(seed)
    out = []
    for n in sizes:
        ms, dispatch, rec = [], [], {"rows": n}
        if first is not None:
            ids = rng.randint(0, num_nodes, size=n)
            ids[0] = 0
            t0 = time.perf_counter()
            got = first(n, ids)
            if got is not None:
                rec["first_ms"] = (time.perf_counter() - t0) * 1e3
                rows, rec["first"] = got
                if keep is not None:
                    keep.append((ids, rows))
        for _ in range(reps):
            ids = rng.randint(0, num_nodes, size=n)
            ids[0] = 0
            t0 = time.perf_counter()
            rows = call(ids)
            ms.append((time.perf_counter() - t0) * 1e3)
            dispatch.append(getattr(rows, "device_ms", None))
            if keep is not None:
                keep.append((ids, rows))
        rec.update(lat_stats(ms), all_ms=ms)
        if any(d is not None for d in dispatch):
            rec["dispatch_ms"] = dispatch
        out.append(rec)
    return out


def profiled(torch, pred, sizes):
    """A ``first`` hook for :func:`request_times`: for each size in
    ``sizes``, one request before the timed ones, straight to
    ``pred.query`` on this thread (the profiler records the thread that
    starts it, not the Server's dispatcher) under torch.profiler: its
    device ms, the host ops with the most self time and the names of the
    device items it ran.  Being the first of its size in the process, it
    is the one that loads that size's kernels."""
    from torch.profiler import ProfilerActivity, profile

    def first(n, ids):
        if n not in sizes:
            return None
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            rows = pred.query(ids)
        ev = prof.key_averages()
        host = sorted(ev, key=lambda e: -e.self_cpu_time_total)[:8]
        dev = [e for e in ev
               if e.device_type == torch.autograd.DeviceType.CUDA]
        return rows, {
            "device_ms": sum(e.device_time_total for e in dev) / 1e3,
            "host_self_ms": [{"name": e.key[:80],
                              "ms": e.self_cpu_time_total / 1e3,
                              "calls": e.count} for e in host],
            "device_items": sorted(e.key[:90] for e in dev)}
    return first


def slice_run(torch, pred, server_cls, first=None):
    """Requests through Server: each size of 1, 8, 64 and 512 rows
    REPEATS times one after another (per size the median, p90, max and
    every time; ``first`` as in :func:`request_times`), then four
    submitted together."""
    results = []
    with server_cls(pred, max_wait_ms=2.0, name="chip_smoke") as srv:
        lat = request_times(lambda ids: srv.submit(ids).result(timeout=300),
                            V, SEED + 2, keep=results, first=first)
        rng = np.random.RandomState(SEED + 3)
        batch = [rng.randint(0, V, size=n) for n in (1, 5, 30, 200)]
        for ids in batch:
            ids[0] = 0
        t0 = time.perf_counter()
        futs = [srv.submit(ids) for ids in batch]
        for ids, f in zip(batch, futs):
            rows = f.result(timeout=300)
            lat.append({"rows": int(ids.size),
                        "ms": (time.perf_counter() - t0) * 1e3,
                        "concurrent": True})
            results.append((ids, rows))
    return lat, results


def _trainer(ds, impl, dropout, params=None, mode="float32", **cfg):
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                             resolve_dtypes)
    dtype, compute_dtype = resolve_dtypes(mode)
    return Trainer(build_gcn(LAYERS, dropout_rate=dropout), ds,
                   TrainConfig(aggr_impl=impl, symmetric=True, seed=SEED,
                               dtype=dtype, compute_dtype=compute_dtype,
                               **TRAIN, **cfg),
                   params=params)


# Each parity step's objective against the plain route's, per dtype mode:
# fp32 sums in another order, compounded over the steps (float32); bf16
# activations rounded at other places (K1 scales by the fp32 d, the plain
# route by d rounded to bf16; rel. 2^-9 a rounding) through two layers,
# and after the first step weights up to ~2 lr apart where a near-zero
# gradient's sign differs between the routes (mixed).
PARITY_RTOL = {"float32": 1e-4, "mixed": 2e-2}


def train_parity(torch, ds, params, mode="float32", steps=3, make=None):
    """From the same weights, dropout 0, ``steps`` steps through
    Trainer.train (or the trainer ``make`` builds) in dtype ``mode`` on
    each kernel route and on the plain 'ell' route on the card.  Each step's objective within
    ``PARITY_RTOL[mode]`` of the plain route's; the weights after the
    steps are reported, not gated: Adam moves a weight by ~lr whatever
    its gradient's size, so a near-zero gradient whose sign differs
    between two summation orders moves it 2 lr apart.  The weights stay
    fp32 in both modes, and in 'mixed' ``feats`` is bf16.  Returns the
    record and the 'cuda' route's logits after the steps (fp32 numpy),
    the yardsticks of the partitioned runs."""
    rtol = PARITY_RTOL[mode]
    losses, weights, step_s = {}, {}, {}
    logits = None
    for impl in ("ell", "cuda", "cuda_csr"):
        tr = (make or _trainer)(ds, impl, 0.0, params=params, mode=mode,
                                eval_every=10 ** 6, verbose=False)
        if any(p.dtype != torch.float32 for p in tr.params.values()) or (
                mode == "mixed" and tr.feats.dtype != torch.bfloat16):
            raise AssertionError(f"{impl} {mode}: params "
                                 f"{[p.dtype for p in tr.params.values()]}"
                                 f", feats {tr.feats.dtype}")
        t0 = time.perf_counter()
        tr.train(steps)
        tr.sync()
        step_s[impl] = (time.perf_counter() - t0) / steps
        losses[impl] = torch.stack(tr.losses).double().cpu().numpy()
        weights[impl] = {k: v.detach().clone() for k, v in tr.params.items()}
        if impl == "cuda":
            logits = tr.predict().float().cpu().numpy()
        del tr
        torch.cuda.empty_cache()
    out = {"mode": mode, "steps": steps, "rtol": rtol,
           "plain_losses": losses["ell"].tolist(),
           "plain_step_s": step_s["ell"]}
    for impl in ("cuda", "cuda_csr"):
        rel = np.abs(losses[impl] - losses["ell"]) / np.abs(losses["ell"])
        diffs = [(weights[impl][k] - weights["ell"][k]).abs()
                 for k in weights["ell"]]
        n = sum(int(t.numel()) for t in diffs)
        out[impl] = {
            "losses": losses[impl].tolist(), "max_rel_loss_err":
            float(rel.max()), "step_s": step_s[impl],
            "max_weight_diff": max(float(t.max()) for t in diffs),
            "share_weights_off_1e-3":
            sum(int((t > 1e-3).sum()) for t in diffs) / n}
        if not (np.isfinite(losses[impl]).all() and rel.max() <= rtol):
            raise AssertionError(f"{impl} losses {losses[impl]} differ from "
                                 f"the plain route's {losses['ell']}")
    return out, logits


@contextlib.contextmanager
def masked_k1_ran(impl, mode, tr, rec):
    """:func:`train_slice`'s check of a GCN run: its relu backward ran
    the masked K1."""
    from roc_tpu_torch.kernels.graphnorm import indegree_norm
    before = indegree_norm.masked_launches
    yield
    rec["masked_k1_launches"] = indegree_norm.masked_launches - before
    if not rec["masked_k1_launches"]:
        raise AssertionError(f"{impl} {mode}: the relu backward never ran "
                             f"the masked K1")


def train_slice(torch, ds, runs, make=None, check=masked_k1_ran):
    """10 epochs, dropout 0.5, an eval every 5, through Trainer (or the
    trainer ``make`` builds, :func:`_dist_trainer`) for each ``(kernel
    route, dtype mode)`` of ``runs`` (fresh Glorot weights from SEED).
    ``check(impl, mode, tr, rec)`` is a context manager around each
    run's training: it adds to the run's record ``rec`` and raises on
    what the run must show (by default :func:`masked_k1_ran`).  Returns
    the phase record, keyed by route (float32) or route/mode; raises on
    a non-finite loss or a train loss that did not fall from epoch 4 to
    epoch 9."""
    from roc_tpu_torch.train.trainer import format_metrics
    out = {}
    for impl, mode in runs:
        key = impl if mode == "float32" else f"{impl}/{mode}"
        t0 = time.perf_counter()
        tr = (make or _trainer)(ds, impl, 0.5, mode=mode, epochs=10,
                                eval_every=5, verbose=False)
        rec = out[key] = {"route": tr.config.aggr_impl,
                          "setup_s": time.perf_counter() - t0}
        with check(impl, mode, tr, rec):
            hist = tr.train()
            tr.sync()
        losses = torch.stack(tr.losses).double().cpu().numpy()
        lines = [format_metrics(m["epoch"], m) for m in hist]
        for ln in lines:
            print(ln, flush=True)
        rec.update(first_step_ms=hist[0]["first_step_ms"],
                   epoch_ms=[m["epoch_ms"] for m in hist],
                   eval_ms=[m["eval_ms"] for m in hist],
                   train_loss=[m["train_loss"] for m in hist],
                   objective=losses.tolist(), infer=lines)
        if not np.isfinite(losses).all() or not all(
                np.isfinite(m["train_loss"]) for m in hist):
            raise AssertionError(f"{key}: non-finite loss {losses}")
        if [m["epoch"] for m in hist] != [4, 9] or not (
                hist[1]["train_loss"] < hist[0]["train_loss"]):
            raise AssertionError(f"{key}: train loss did not fall: "
                                 f"{lines}")
        del tr
        torch.cuda.empty_cache()
    return out


def _kernel_group(name):
    """The part of a training step a device kernel belongs to."""
    for group, keys in (("K3 csr_spmm", ("csr_row_sum", "csr_row_ptr")),
                        ("K4 ell_aggregate", ("ell_bucket_sum",)),
                        ("K1/K2 row scale", ("row_scale_",)),
                        ("matmul", ("gemm", "Gemm", "cutlass", "xmma")),
                        ("collectives, device copies", ("nccl", "Memcpy"))):
        if any(k in name for k in keys):
            return group
    return "other (dropout, loss, Adam, copies)"


def train_profile(torch, ds, mode="float32", steps=3, make=None,
                  impls=("cuda", "cuda_csr")):
    """Where a steady training step's device time goes, per kernel
    route, in dtype ``mode``: ``steps`` steps (after 2 warm ones, and
    one more under a first profiler session whose trace is discarded and
    whose wall clock is reported as ``warm_profiled_step_ms``) of
    Trainer (or the trainer ``make`` builds) under torch.profiler, kernel
    time summed by group, and the device's idle share of the host wall
    clock (1 - kernel time / wall), for each route of ``impls``, with
    the shares outside K1-K4 and in GEMMs.  Dropout 0.5, as in the train
    slice.  Reports "not measured" if the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    out = {"mode": mode}
    for impl in impls:
        tr = (make or _trainer)(ds, impl, 0.5, mode=mode,
                                eval_every=10 ** 6, verbose=False)
        tr.train(2)
        tr.sync()
        with profile(activities=activities):
            t0 = time.perf_counter()
            tr.train(1)
            tr.sync()
            warm_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            tr.train(steps)
            tr.sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        groups, names, other = {}, {}, {}
        for e in prof.key_averages():
            # the device's own kernel events only: a host op's device
            # time repeats that of the kernels it launched, and so does
            # the device-side range of an NCCL call ("nccl:...") that of
            # the copies or kernels it issued
            if e.device_type != torch.autograd.DeviceType.CUDA or \
                    e.key.startswith("nccl:"):
                continue
            us = e.device_time_total
            if us > 0:
                g = _kernel_group(e.key)
                groups[g] = groups.get(g, 0.0) + us / 1e3 / steps
                names[e.key] = names.get(e.key, 0.0) + us / 1e3 / steps
                if g.startswith("other"):
                    # every kernel of the group, with its launches a step
                    other[e.key[:160]] = [us / 1e3 / steps,
                                          e.count / steps]
        busy = sum(groups.values())
        rec = {"wall_ms_per_step": wall_ms / steps,
               "warm_profiled_step_ms": warm_ms}
        if busy <= 0:
            rec["device"] = "not measured"
        else:
            rec.update(
                device_ms_per_step=busy, idle_share=1 - busy * steps / wall_ms,
                groups_ms_per_step=groups,
                group_share={g: v / busy for g, v in groups.items()},
                share_outside_k1_k4=1 - sum(
                    v for g, v in groups.items() if g.startswith("K")) / busy,
                top_kernels_ms_per_step=sorted(
                    names.items(), key=lambda kv: -kv[1])[:8],
                other_kernels_ms_calls_per_step=sorted(
                    other.items(), key=lambda kv: -kv[1][0]))
        out[impl] = rec
        del tr, prof
        torch.cuda.empty_cache()
    return out


# Served logits against the plain 'ell' route in the same mode on the
# card, as a share of the logit scale: fp32 sums in another order, two
# layers deep (float32); bf16 activations rounded at other places (K1
# scales by the fp32 d, the plain route by d rounded to bf16; rel. 2^-9 a
# rounding) through two layers and two bf16 products (mixed).  And in
# mixed against the fp32 route: bf16 features, weights and activations.
SERVE_TOL = {"float32": 1e-4, "mixed": 3e-2}
SERVE_TOL_VS_FP32 = 5e-2


def serve_check(torch, pred, results, mode, fp32_ref=None):
    """The served rows against the plain 'ell' route in ``mode`` on the
    card (and, given ``fp32_ref``, the fp32 route's logits), finite, of
    the right shape, and the id-0 row the same bits in every request,
    coalesced or not.  Returns the plain route's logits (fp32 numpy)."""
    with torch.inference_mode():
        plain_ctx = dataclasses.replace(pred.gctx, aggr_impl="ell")
        ref = pred.model.apply(pred.params, pred.published().table,
                               plain_ctx, train=False).float().cpu().numpy()
    scale = float(np.abs(ref).max())
    worst = worst32 = 0.0
    row0 = None
    for ids, rows in results:
        rows = np.asarray(rows)
        assert rows.shape == (ids.size, LAYERS[-1]), rows.shape
        assert rows.dtype == np.float32 and np.isfinite(rows).all()
        worst = max(worst, float(np.abs(rows - ref[ids]).max()))
        if fp32_ref is not None:
            worst32 = max(worst32, float(np.abs(rows - fp32_ref[ids]).max()))
        # id 0 rides in every request: coalesced or not, the same bits
        row0 = rows[0] if row0 is None else row0
        assert np.array_equal(rows[0], row0)
    tol = SERVE_TOL[mode] * max(scale, 1.0)
    rec = {"phase": "check", "mode": mode, "max_abs_err": worst,
           "atol": tol, "logit_scale": scale}
    tol32 = None
    if fp32_ref is not None:
        tol32 = SERVE_TOL_VS_FP32 * max(float(np.abs(fp32_ref).max()), 1.0)
        rec.update(max_abs_err_vs_fp32=worst32, atol_vs_fp32=tol32)
    log(rec)
    if not worst <= tol:
        raise AssertionError(f"{mode} served logits differ from the plain "
                             f"route: {worst} > {tol}")
    if tol32 is not None and not worst32 <= tol32:
        raise AssertionError(f"{mode} served logits differ from the fp32 "
                             f"route: {worst32} > {tol32}")
    return ref


def kernel_share(record, entries):
    """The kernels' share of a steady step, from the kernel phase's times
    of the run's dtype: each of the two layers runs its chain once
    forward, once backward, the relu layer's (F = 256) backward with the
    masked K1."""
    k1 = entries["indegree_norm"]
    k1_256 = sum(r["ms"] for r in k1["shapes"] if r["shape"][1] == 256)
    chain = (2 * k1["ms"] - k1_256 + entries["indegree_norm_masked"]["ms"]
             + 2 * entries["scale_act"]["ms"])
    for key, rec in record.items():
        agg = "csr_spmm" if key.startswith("cuda_csr") else "ell_aggregate"
        steady = [ms for ms in rec["epoch_ms"] if ms]
        step_ms = sum(steady) / len(steady)
        est = chain + 2 * entries[agg]["ms"]
        rec.update(kernel_ms_per_step_est=est, kernel_share_est=est / step_ms,
                   aggregate_share_est=2 * entries[agg]["ms"] / step_ms)


def check_train_launches(launches, key):
    """Every kernel of the training path ran in dtype ``key`` and none in
    the other, the masked K1 included; K3's pre-pass once per main
    pass."""
    other = BF16 if key == F32 else F32
    by = {k: v for k, v in launches.items()
          if k not in ("csr_row_ptr", "indegree_norm_masked")}
    if not all(v[key] for v in by.values()) or any(
            v[other] for v in by.values()) or (
            not launches["indegree_norm_masked"]) or (
            launches["csr_row_ptr"] != by["csr_spmm"][key]):
        raise AssertionError(f"a {key} kernel of the training path never "
                             f"ran, or another dtype did: {launches}")


def _dist_trainer(ds, impl, dropout, params=None, mode="float32",
                  num_parts=1, device=None, **cfg):
    """:func:`_trainer`'s partitioned twin: DistributedTrainer over the
    default process group, whose world size is ``num_parts``."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.parallel.distributed import DistributedTrainer
    from roc_tpu_torch.train.trainer import TrainConfig, resolve_dtypes
    dtype, compute_dtype = resolve_dtypes(mode)
    return DistributedTrainer(
        build_gcn(LAYERS, dropout_rate=dropout), ds, num_parts,
        TrainConfig(aggr_impl=impl, symmetric=True, seed=SEED, dtype=dtype,
                    compute_dtype=compute_dtype, **TRAIN, **cfg),
        params=params, device=device)


def dist_parity(torch, ds, params, parity, mode, steps=3):
    """From the same weights, dropout 0, ``steps`` steps of
    DistributedTrainer (world size 1) on each kernel route in dtype
    ``mode``; each step's objective within ``PARITY_RTOL[mode]`` of
    Trainer's on the same route (``parity``, train_parity's record)."""
    rtol = PARITY_RTOL[mode]
    out = {"mode": mode, "steps": steps, "rtol": rtol}
    for impl in ("cuda", "cuda_csr"):
        t0 = time.perf_counter()
        tr = _dist_trainer(ds, impl, 0.0, params=params, mode=mode,
                           eval_every=10 ** 6, verbose=False)
        setup_s = time.perf_counter() - t0
        tr.train(steps)
        tr.sync()
        got = torch.stack(tr.losses).double().cpu().numpy()
        want = np.asarray(parity[impl]["losses"])
        rel = np.abs(got - want) / np.abs(want)
        out[impl] = {"setup_s": setup_s, "part_nodes": tr.plan.part_nodes,
                     "part_edges": tr.plan.part_edges,
                     "losses": got.tolist(), "trainer_losses": want.tolist(),
                     "max_rel_loss_err": float(rel.max())}
        if not (np.isfinite(got).all() and rel.max() <= rtol):
            raise AssertionError(f"partitioned {impl} {mode} losses {got} "
                                 f"differ from Trainer's {want}")
        del tr
        torch.cuda.empty_cache()
    return out


def _save_dataset(ds, path):
    """The dataset's arrays as .npy files under ``path``, for the rank
    processes of dist_p2 to map."""
    for name, arr in (("row_ptr", ds.graph.row_ptr),
                      ("col_idx", ds.graph.col_idx),
                      ("features", ds.features), ("labels", ds.labels),
                      ("mask", ds.mask)):
        np.save(f"{path}/{name}.npy", arr)


def _map_dataset(path, num_classes, name="reddit_shape", mmap=True):
    """The dataset :func:`_save_dataset` wrote under ``path``, its arrays
    mapped read-only (or with ``mmap`` False read into memory)."""
    from roc_tpu_torch.core.graph import Dataset, Graph

    def load(name):
        return np.load(f"{path}/{name}.npy", mmap_mode="r" if mmap else None)
    return Dataset(Graph(load("row_ptr"), load("col_idx")), load("features"),
                   load("labels"), load("mask"), num_classes, name=name)


def rank_kernel_checks(torch, tr, ds):
    """This rank's kernels at the shapes of its part against their plain
    versions (the counts are zeroed after): K4, and K3 over the part's
    edge list, reading R = P * part_nodes gathered rows and writing
    part_nodes rows (:func:`sum_check`); K1, the masked K1 and K2 on
    part_nodes rows, bit for bit."""
    from roc_tpu_torch.kernels import ell_spmm, graphnorm, spmm
    from roc_tpu_torch.parallel.distributed import shard_dataset
    d, pn, R = tr.data, tr.plan.part_nodes, tr.plan.padded_num_nodes
    edges = shard_dataset(ds, tr.plan, tr.rank, tr.device,
                          aggr_impl="cuda_csr")
    gen = torch.Generator(device=tr.device).manual_seed(SEED + 7 + tr.rank)
    deg, scale = d.in_degree, tr.gctx.inv_sqrt_deg
    rows = []
    for F, act in ((256, "relu"), (41, "none")):
        x = torch.randn((R, F), generator=gen, device=tr.device)
        xl = x[:pn]
        y = torch.relu(torch.randn((pn, F), generator=gen,
                                   device=tr.device))
        for name, got, want, exact in (
                ("ell_aggregate",
                 ell_spmm.ell_aggregate(x, d.ell_idx, d.ell_row_id, pn),
                 ell_spmm.ell_aggregate_plain(x, d.ell_idx, d.ell_row_id,
                                              pn), False),
                ("csr_spmm",
                 spmm.csr_spmm(x, edges.edge_src, edges.edge_dst, pn),
                 spmm.csr_spmm_plain(x, edges.edge_src, edges.edge_dst, pn),
                 False),
                ("indegree_norm", graphnorm.indegree_norm(xl, deg),
                 graphnorm.indegree_norm_plain(xl, deg), True),
                ("indegree_norm_masked",
                 graphnorm.indegree_norm(xl, deg, relu_out=y),
                 graphnorm.indegree_norm_plain(xl, deg, relu_out=y), True),
                ("scale_act", graphnorm.scale_act(xl, scale, act),
                 graphnorm.scale_act_plain(xl, scale, act), True)):
            if exact:
                ok = bool(torch.equal(got, want))
                err = float((got - want).abs().max())
            else:
                ok, err = sum_check(torch, got, want)
            rows.append({"kernel": name, "F": F, "R": R, "rows": pn,
                         "max_abs_err": err, "ok": ok})
            if not ok:
                raise AssertionError(f"rank {tr.rank}: {name} at F={F}, "
                                     f"R={R}, {pn} rows: max_abs_err {err}")
        del x, xl, y
    del edges
    torch.cuda.synchronize()
    return rows


def time_collectives(torch, tr, n=3):
    """The collectives of one step timed alone, at the step's shapes and
    count (each synchronised, mean of ``n``): two all-gathers of
    ``[part_nodes, 256]`` and two of ``[part_nodes, 41]`` (forward and
    the backward's rerun) and one all-reduce of the gradients and the
    objective."""
    comm, pn = tr.comm, tr.plan.part_nodes
    x256 = torch.zeros((pn, 256), device=tr.device)
    x41 = torch.zeros((pn, 41), device=tr.device)
    flat = torch.zeros(sum(p.numel() for p in tr.params.values()) + 1,
                       device=tr.device)
    ms = {}
    for name, fn in (("all_gather_256", lambda: comm.all_gather(x256)),
                     ("all_gather_41", lambda: comm.all_gather(x41)),
                     ("all_reduce", lambda: comm.all_reduce(flat))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3 / n
    ms["per_step"] = (2 * ms["all_gather_256"] + 2 * ms["all_gather_41"]
                      + ms["all_reduce"])
    return ms


def dist_rank_job(data_dir, num_classes, params, steps):
    """One rank of dist_p2, in a spawned process on card 0: map the
    dataset, build its part (the 'cuda' route, fp32), check its kernels
    at the part's shapes, then, with the counts zeroed, ``steps`` steps
    from ``params`` (dropout 0), each synchronised; time the step's
    collectives alone; predict.  Returns its record (rank 0 with the
    logits)."""
    import torch
    from roc_tpu_torch.kernels import _build, ell_spmm, graphnorm, spmm
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    set_fp32_matmul_precision()
    t0 = time.perf_counter()
    ds = _map_dataset(data_dir, num_classes)
    tr = _dist_trainer(ds, "cuda", 0.0, num_parts=2, device=dev,
                       params={k: torch.from_numpy(v)
                               for k, v in params.items()},
                       eval_every=10 ** 6, verbose=False)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    checks = rank_kernel_checks(torch, tr, ds)
    kernels = (graphnorm.indegree_norm, graphnorm.scale_act, spmm.csr_spmm,
               ell_spmm.ell_aggregate)
    _build.zero_launches(*kernels)
    graphnorm.indegree_norm.masked_launches = 0
    step_ms = []
    for _ in range(steps):
        t = time.perf_counter()
        tr.train(1)
        tr.sync()
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = {k.__name__: dict(k.launches_by_dtype) for k in kernels}
    launches["indegree_norm_masked"] = graphnorm.indegree_norm.masked_launches
    coll = time_collectives(torch, tr)
    logits = tr.predict().float().cpu().numpy()
    plan = tr.plan
    return {"rank": tr.rank, "backend": tr.comm.backend,
            "bounds": [list(b) for b in plan.bounds],
            "part_nodes": plan.part_nodes, "part_edges": plan.part_edges,
            "real_nodes": plan.real_nodes.tolist(),
            "real_edges": plan.real_edges.tolist(), "setup_s": setup_s,
            "step_ms": step_ms,
            "losses": torch.stack(tr.losses).double().cpu().tolist(),
            "launches": launches, "collectives_ms": coll,
            "kernel_checks": checks,
            "logits": logits if tr.rank == 0 else None}


# dist_p2's logits against Trainer's on the card, as a share of the logit
# scale: fp32 sums in another order, two layers deep, after 3 steps
PREDICT_TOL = 1e-4


def dist_p2(torch, ds, params, parity, trainer_logits, data_dir, steps=3):
    """Two fresh rank processes on card 0 over gloo (NCCL takes one rank
    per card), each holding one part of the edge-balanced split, the
    'cuda' route in fp32: ``steps`` steps from ``params`` with dropout 0,
    each step's objective within ``PARITY_RTOL['float32']`` of Trainer's
    (``parity``) and the logits after them within ``PREDICT_TOL`` of
    max|logit| of Trainer's (``trainer_logits``); the ranks map ``ds``
    from its files in ``data_dir``.  Returns the record and the ranks'
    launch counts."""
    from roc_tpu_torch.parallel.distributed import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(dist_rank_job, 2, backend="gloo", timeout_s=900,
                      data_dir=data_dir, num_classes=ds.num_classes,
                      params={k: v.detach().cpu().numpy()
                              for k, v in params.items()},
                      steps=steps)
    wall_s = time.perf_counter() - t0
    rtol = PARITY_RTOL["float32"]
    want = np.asarray(parity["cuda"]["losses"])
    logits = ranks[0].pop("logits")
    ranks[1].pop("logits")
    scale = float(np.abs(trainer_logits).max())
    err = float(np.abs(logits - trainer_logits).max())
    out = {"wall_s": wall_s, "ranks": ranks,
           "trainer_losses": want.tolist(), "rtol": rtol,
           "predict_max_abs_err": err,
           "predict_atol": PREDICT_TOL * max(scale, 1.0),
           "note": "two CUDA contexts time-slice one card and gloo stages "
                   "the collectives through the host: a layout check, "
                   "not a speed number"}
    for r in ranks:
        got = np.asarray(r["losses"])
        rel = np.abs(got - want) / np.abs(want)
        r["max_rel_loss_err"] = float(rel.max())
        steady = r["step_ms"][1:]
        r["steady_step_ms"] = sum(steady) / len(steady)
        r["collective_share"] = (r["collectives_ms"]["per_step"]
                                 / r["steady_step_ms"])
        if not (np.isfinite(got).all() and rel.max() <= rtol):
            raise AssertionError(f"rank {r['rank']}: partitioned losses "
                                 f"{got} differ from Trainer's {want}")
        by = r["launches"]
        if not (by["indegree_norm"][F32] and by["scale_act"][F32]
                and by["ell_aggregate"][F32] and by["indegree_norm_masked"]):
            raise AssertionError(f"rank {r['rank']}: a kernel of the path "
                                 f"never ran: {by}")
    if not (logits.shape == trainer_logits.shape and np.isfinite(
            logits).all() and err <= out["predict_atol"]):
        raise AssertionError(f"partitioned logits differ from Trainer's: "
                             f"{err} > {out['predict_atol']}")
    return out, [r["launches"] for r in ranks]


# ------------------------------------------------------------ 11. recovery

# the recovery runs: 10 epochs, dropout 0.5, an eval every 5, a
# checkpoint every 2 under a keep-3 rotation
RECOVERY_EPOCHS, CKPT_EVERY = 10, 2


def _state_diff(torch, a, b):
    """The names of the state leaves (params, Adam m and v, the step
    scalars, every step's objective) where trainers ``a`` and ``b``
    differ in a single bit."""
    bad = [f"{tree}[{k}]" for tree, x, y in (
        ("params", a.params, b.params), ("m", a.opt_state.m, b.opt_state.m),
        ("v", a.opt_state.v, b.opt_state.v))
        for k in x if not torch.equal(x[k], y[k])]
    for k in ("step", "beta1_t", "beta2_t"):
        if getattr(a.opt_state, k) != getattr(b.opt_state, k):
            bad.append(k)
    if not torch.equal(torch.stack(a.losses), torch.stack(b.losses)):
        bad.append("losses")
    return bad


def _steady_ms(wall_ms, tr):
    """Wall ms per epoch after the first step."""
    return (wall_ms - tr.first_step_ms) / (RECOVERY_EPOCHS - 1)


def _rounds(tr, at_boundary):
    """RECOVERY_EPOCHS epochs in rounds of CKPT_EVERY, ``at_boundary(tr)``
    after each round (train_with_recovery's structure, without it)."""
    hist = []
    while tr.epoch < RECOVERY_EPOCHS:
        hist += tr.train(CKPT_EVERY)
        at_boundary(tr)
    return hist


def recovery_pair(torch, ds, impl, mode, root):
    """``RECOVERY_EPOCHS`` epochs through Trainer.train, then from the
    same seed through train_with_recovery with an async rotation: the
    final params, Adam state and every objective must be equal bit for
    bit (saving must not perturb training).  To split what a save costs
    the step path (with ``--deep``), the same rounds run twice more
    without a rotation:
    ending in the finite guard alone (the drain of the launched steps)
    and in the guard and the host snapshot (the step path's whole share
    of an async save, the saver thread's writes left out), each held to
    the same bits.  The variants run in turns, the plain one first and
    again last; each overhead is against the mean of the two plain
    readings.  Returns the record, the first plain trainer and the
    rotation."""
    from roc_tpu_torch.resilience.recovery import (CheckpointRotation,
                                                   check_params_finite,
                                                   train_with_recovery)
    from roc_tpu_torch.utils.checkpoint import snapshot_trainer

    def guard(tr):
        check_params_finite(tr.params, tr.opt_state)

    def snapshot(tr):
        guard(tr)
        snapshot_trainer(tr).wait()

    rot = CheckpointRotation(f"{root}/{impl}_{mode}/ck", keep=3,
                             async_save=True)
    variants = {
        "plain": lambda tr: tr.train(),
        **({"guard_only": lambda tr: _rounds(tr, guard),
            "snapshot_only": lambda tr: _rounds(tr, snapshot)}
           if DEEP else {}),
        "recovered": lambda tr: train_with_recovery(
            tr, RECOVERY_EPOCHS, rot, checkpoint_every=CKPT_EVERY),
        "plain_again": lambda tr: tr.train()}
    out = {"route": impl, "mode": mode}
    plain, bad = None, {}
    for name, run in variants.items():
        tr = _trainer(ds, impl, 0.5, mode=mode, epochs=RECOVERY_EPOCHS,
                      eval_every=5, verbose=False)
        tr.sync()
        t0 = time.perf_counter()
        hist = run(tr)
        tr.sync()
        wall = (time.perf_counter() - t0) * 1e3
        out[name] = {"wall_ms": wall, "steady_epoch_ms": _steady_ms(wall, tr),
                     "epoch_ms": [m["epoch_ms"] for m in hist],
                     "first_step_ms": tr.first_step_ms,
                     "train_loss": [m["train_loss"] for m in hist]}
        if plain is None:
            plain = tr
        else:
            bad[name] = _state_diff(torch, plain, tr)
            del tr
            torch.cuda.empty_cache()
    base = (out["plain"]["steady_epoch_ms"]
            + out["plain_again"]["steady_epoch_ms"]) / 2
    for name in ("guard_only", "snapshot_only", "recovered"):
        if name in out:
            out[name]["overhead_share"] = \
                out[name]["steady_epoch_ms"] / base - 1
    st = rot.save_stats()
    out["saves"] = [{k: s[k] for k in ("epoch", "block_ms", "write_ms",
                                        "commit_ms", "queued_ms", "bytes")}
                    for s in st["saves"]]
    out["superseded"] = st["superseded"]
    out["checkpoints"] = rot.existing()
    out["overhead_share"] = out["recovered"]["overhead_share"]
    out["bit_equal"] = not any(bad.values())
    # every save either committed or was superseded by a newer one while
    # the saver was busy (queue depth 1); the last one committed, and the
    # keep window holds
    ck = rot.existing()
    n_saves = RECOVERY_EPOCHS // CKPT_EVERY
    if any(bad.values()) or not ck or ck[-1] != RECOVERY_EPOCHS or \
            len(ck) > 3 or st["saved"] + st["superseded"] != n_saves:
        raise AssertionError(f"{impl} {mode}: a checkpointed run differs from "
                             f"the uninterrupted one at {bad}, or its "
                             f"checkpoints are {ck} after {st['saved']} saves "
                             f"and {st['superseded']} superseded")
    return out, plain, rot


def save_timings(torch, tr, root, n=3):
    """``n`` sync saves and ``n`` async saves of a trained trainer (each
    async one flushed), and the finite guard timed alone: after a sync,
    and right after a step was launched (then it waits for the step)."""
    from roc_tpu_torch.resilience.recovery import (CheckpointRotation,
                                                   check_params_finite)
    keys = ("block_ms", "write_ms", "commit_ms", "save_ms", "bytes")
    out = {}
    for mode in ("sync", "async"):
        rot = CheckpointRotation(f"{root}/timing_{mode}/ck", keep=n + 1,
                                 async_save=mode == "async")
        calls = []
        for _ in range(n):
            tr.epoch += 1
            t0 = time.perf_counter()
            rot.save(tr)
            calls.append((time.perf_counter() - t0) * 1e3)
            rot.flush()
        rot.drain()
        out[mode] = {"call_ms": calls,
                     "saves": [{k: s[k] for k in keys}
                               for s in rot.save_stats()["saves"]]}
    guard = {"idle_ms": [], "after_step_ms": []}
    for _ in range(n):
        tr.sync()
        t0 = time.perf_counter()
        check_params_finite(tr.params, tr.opt_state)
        guard["idle_ms"].append((time.perf_counter() - t0) * 1e3)
        tr.train(1)
        t0 = time.perf_counter()
        check_params_finite(tr.params, tr.opt_state)
        guard["after_step_ms"].append((time.perf_counter() - t0) * 1e3)
    out["finite_guard"] = guard
    return out


def recovery_child(data_dir, num_classes, prefix, fault, out_path):
    """One recovery run in a fresh process on card 0 (phase 11's kill
    drill): map the dataset, build the 'cuda' fp32 trainer (dropout 0.5,
    ``fault`` armed), resume from the rotation at ``prefix`` and train
    to RECOVERY_EPOCHS; prints ``{"setup_s": ...}`` once set up, and
    saves the final state, the objectives, the epoch resumed from and
    the launch counts to ``out_path``."""
    import torch
    from roc_tpu_torch.kernels import _build, ell_spmm, graphnorm, spmm
    from roc_tpu_torch.obs import events
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    from roc_tpu_torch.resilience.recovery import (CheckpointRotation,
                                                   train_with_recovery)
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    events.configure(jsonl_path=f"{out_path}.events.jsonl")
    t0 = time.perf_counter()
    ds = _map_dataset(data_dir, num_classes)
    tr = _trainer(ds, "cuda", 0.5, epochs=RECOVERY_EPOCHS, eval_every=5,
                  verbose=False, fault=fault or None)
    tr.sync()
    print(json.dumps({"setup_s": time.perf_counter() - t0}), flush=True)
    kernels = (graphnorm.indegree_norm, graphnorm.scale_act, spmm.csr_spmm,
               ell_spmm.ell_aggregate)
    _build.zero_launches(*kernels)
    graphnorm.indegree_norm.masked_launches = 0
    rot = CheckpointRotation(prefix, keep=3, async_save=True)
    resumed = rot.restore_latest(tr, only_if_ahead=True)
    train_with_recovery(tr, RECOVERY_EPOCHS, rot, checkpoint_every=CKPT_EVERY)
    tr.sync()
    launches = {k.__name__: dict(k.launches_by_dtype) for k in kernels}
    launches["indegree_norm_masked"] = graphnorm.indegree_norm.masked_launches
    np.savez(out_path, losses=torch.stack(tr.losses).double().cpu().numpy(),
             **{f"{t}.{k}": v.detach().cpu().numpy() for t, tree in (
                 ("params", tr.params), ("m", tr.opt_state.m),
                 ("v", tr.opt_state.v)) for k, v in tree.items()},
             scalars=np.asarray([tr.opt_state.step, tr.opt_state.beta1_t,
                                 tr.opt_state.beta2_t], np.float64),
             meta=np.frombuffer(json.dumps(
                 {"resumed_from": resumed, "launches": launches,
                  "epoch": tr.epoch}).encode(), np.uint8))


def start_recovery_child(root, data_dir, fault, tag):
    """:func:`recovery_child` pre-started (:class:`_Child`, its output
    captured): the kill drill's run ``tag`` on the dataset in
    ``data_dir`` over the rotation at ``root``/drill/ck, ``fault``
    armed, its flight records under ``root``."""
    env = dict(os.environ, ROC_TPU_FLIGHT_DIR=root)
    env.pop("ROC_TPU_FAULT", None)
    return _Child(f"recovery_child({data_dir!r}, {LAYERS[-1]}, "
                  f"{root + '/drill/ck'!r}, {fault!r}, "
                  f"{root + '/' + tag + '.npz'!r})", 600,
                  f"the kill drill's {tag}", capture=True, env=env)


def _setup_s(child):
    """The set-up seconds a recovery child printed, or None."""
    setup = [json.loads(ln)["setup_s"] for ln in child.stdout.splitlines()
             if ln.startswith('{"setup_s"')]
    return setup[0] if setup else None


def kill_drill(torch, root, data_dir, want, child1):
    """Child 1 (pre-started, :func:`start_recovery_child`) runs the fp32
    'cuda' recovery run with kill_in_async_save at epoch 4 and must die
    by SIGKILL, leaving ck.4 with a shard and no manifest and ck.2
    committed; child 2 runs the identical job, resumes from ck.2 with no
    corrupt_fallback event, and must end on ``want`` (the uninterrupted
    run's trainer) bit for bit.  Returns the record and child 2's launch
    counts."""
    import signal
    from roc_tpu_torch.utils.checkpoint import is_committed
    prefix = f"{root}/drill/ck"
    os.makedirs(f"{root}/drill", exist_ok=True)
    # child 2 sets up while child 1 runs
    child2 = start_recovery_child(root, data_dir, "", "child2")
    out = {"child1_rc": child1.run(check=False),
           "child1_setup_s": _setup_s(child1)}
    ck4 = sorted(os.listdir(f"{prefix}.4")) if os.path.isdir(
        f"{prefix}.4") else None
    out["ck4_after_kill"] = ck4
    if out["child1_rc"] != -signal.SIGKILL or ck4 != ["shard_00000.npz"] \
            or not is_committed(f"{prefix}.2"):
        raise AssertionError(f"kill drill: child 1 rc {out['child1_rc']}, "
                             f"ck.4 holds {ck4}, ck.2 committed "
                             f"{is_committed(prefix + '.2')}: "
                             f"{child1.stderr[-3000:]}")
    out["child2_rc"] = child2.run(check=False)
    out["child2_setup_s"] = _setup_s(child2)
    if out["child2_rc"] != 0:
        raise AssertionError(f"kill drill: child 2 failed: "
                             f"{child2.stderr[-3000:]}")
    path = f"{root}/child2.npz"
    got = np.load(path)
    meta = json.loads(bytes(got["meta"]))
    evs = [json.loads(ln) for ln in open(f"{path}.events.jsonl")]
    out.update(resumed_from=meta["resumed_from"], epoch=meta["epoch"],
               corrupt_fallbacks=sum(e.get("kind") == "corrupt_fallback"
                                     for e in evs))
    bad = [f"{t}.{k}" for t, tree in (("params", want.params),
                                      ("m", want.opt_state.m),
                                      ("v", want.opt_state.v))
           for k, v in tree.items()
           if not np.array_equal(got[f"{t}.{k}"], v.detach().cpu().numpy())]
    want_losses = torch.stack(want.losses).double().cpu().numpy()
    if not np.array_equal(got["losses"], want_losses[2:]):
        bad.append("losses")
    st = want.opt_state
    if not np.array_equal(got["scalars"], np.asarray(
            [st.step, st.beta1_t, st.beta2_t], np.float64)):
        bad.append("step scalars")
    out["bit_equal"] = not bad
    if bad or meta["resumed_from"] != 2 or out["corrupt_fallbacks"] or \
            meta["epoch"] != RECOVERY_EPOCHS:
        raise AssertionError(f"kill drill: child 2 resumed from "
                             f"{meta['resumed_from']}, "
                             f"{out['corrupt_fallbacks']} fallbacks, differs "
                             f"from the uninterrupted run at {bad}")
    return out, meta["launches"]


def nan_drill(torch, ds, root):
    """nan_grads:3 on 'cuda_csr' fp32 under a sync rotation: the save
    after epoch 3 refuses the poisoned state, the run restores epoch 2,
    retries once and ends with a finite loss."""
    from roc_tpu_torch.obs.events import get_bus
    from roc_tpu_torch.resilience import inject
    from roc_tpu_torch.resilience.recovery import (CheckpointRotation,
                                                   train_with_recovery)
    tr = _trainer(ds, "cuda_csr", 0.5, epochs=6, eval_every=5, verbose=False,
                  fault="nan_grads:3")
    rot = CheckpointRotation(f"{root}/nan/ck", keep=3)
    bus = get_bus()
    n = len(bus.ring)
    try:
        hist = train_with_recovery(tr, 6, rot, checkpoint_every=CKPT_EVERY)
    finally:
        inject.disarm()
    recs = list(bus.ring)[n:]
    retries = [r["epoch"] for r in recs if r.get("kind") == "recovery"]
    faults = [r["site"] for r in recs if r.get("kind") == "fault"]
    final = float(tr.evaluate()["train_loss"])
    out = {"route": "cuda_csr", "retries_at_epoch": retries,
           "faults": faults, "final_train_loss": final,
           "evals": [[m["epoch"], m["train_loss"]] for m in hist],
           "checkpoints": rot.existing()}
    if retries != [4] or faults != ["nan_grads"] or not np.isfinite(final) \
            or tr.epoch != 6:
        raise AssertionError(f"nan_grads drill: {out}")
    del tr
    torch.cuda.empty_cache()
    return out


def serve_from_checkpoint(torch, ds, path, trainer):
    """The checkpoint's params (``restore_params_only``) served through
    build_predictor and Server on the trainer's route and dtype: ~8 ids
    in two requests, each row equal bit for bit to ``trainer.predict``'s
    row."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.serve.export import build_predictor
    from roc_tpu_torch.serve.server import Server
    from roc_tpu_torch.train.trainer import TrainConfig
    from roc_tpu_torch.utils.checkpoint import restore_params_only
    params, fp, epoch = restore_params_only(path)
    pred = build_predictor(build_gcn(LAYERS), ds,
                           TrainConfig(aggr_impl=trainer.config.aggr_impl,
                                       symmetric=True, seed=SEED, **TRAIN),
                           params=params, backend="full")
    rng = np.random.RandomState(SEED + 11)
    reqs = [rng.randint(0, V, size=6), rng.randint(0, V, size=2)]
    with Server(pred, max_wait_ms=2.0, name="chip_smoke_ckpt") as srv:
        futs = [srv.submit(ids) for ids in reqs]
        rows = [f.result(timeout=300) for f in futs]
    equal = [bool(np.array_equal(r, trainer.predict(ids).float().cpu()
                                 .numpy())) for ids, r in zip(reqs, rows)]
    out = {"epoch": epoch, "ids": sum(int(ids.size) for ids in reqs),
           "rows_bit_equal": equal, "fingerprint": fp.get("strict")}
    del pred
    torch.cuda.empty_cache()
    if not all(equal) or epoch != RECOVERY_EPOCHS:
        raise AssertionError(f"served rows from the checkpoint differ from "
                             f"Trainer.predict's: {out}")
    return out


def recovery(torch, ds, zero_counts, read_counts, root, data_dir, child1):
    """Phase 11 under ``root`` (the dataset's files in ``data_dir``, the
    kill drill's child 1 pre-started there): the fp32 path (the 'cuda'
    pair, with ``--deep`` its save timings, the kill drill's children,
    the nan_grads drill on 'cuda_csr', serving from the checkpoint) with
    the counts zeroed before and read after, then the 'mixed' pair on
    'cuda_csr' the same way.  Returns the record, the two reads and
    child 2's launches."""
    rec = {}
    # the fault sites' flight records go with the checkpoints
    os.environ["ROC_TPU_FLIGHT_DIR"] = root
    try:
        zero_counts()
        rec["cuda_fp32"], plain, rot = recovery_pair(torch, ds, "cuda",
                                                     "float32", root)
        rec["kill_drill"], child = kill_drill(torch, root, data_dir, plain,
                                              child1)
        rec["nan_drill"] = nan_drill(torch, ds, root)
        rec["serve"] = serve_from_checkpoint(torch, ds, rot.path(10), plain)
        f32 = read_counts(F32)
        if DEEP:
            rec["save_timings"] = save_timings(torch, plain, root)
        del plain
        torch.cuda.empty_cache()
        zero_counts()
        rec["cuda_csr_mixed"], plain, _ = recovery_pair(torch, ds, "cuda_csr",
                                                        "mixed", root)
        bf16 = read_counts(BF16)
        del plain
        torch.cuda.empty_cache()
    finally:
        os.environ.pop("ROC_TPU_FLIGHT_DIR")
    return rec, f32, bf16, child


# Phase 12, the model zoo at ogbn-arxiv's shape: its V, about its 4.6 M
# directed edges (synthetic, symmetric, self edges in, from a seed) and
# the widths of benchmarks/model_zoo.py's configs 3, 6, 8 and 9: 128
# input features, 256 hidden, 40 classes.
ZOO_V = 169_343
ZOO_DEGREE = 28
ZOO_LAYERS = [128, 256, 40]
MODES = ("float32", "mixed")
_SUM = ("ell_aggregate",)
_CHAIN = ("indegree_norm", "ell_aggregate", "scale_act")
# family -> (registry name, builder kwargs, layers, dtype modes, the
# kernels a run on 'cuda' launches; on 'cuda_csr' K3 stands for K4)
ZOO = {
    "sage_mean": ("sage", {}, ZOO_LAYERS, MODES, _SUM),
    "sage_norm": ("sage", {"use_norm": True}, ZOO_LAYERS, MODES, _CHAIN),
    "sage_pool": ("sage", {"aggregator": "pool"}, ZOO_LAYERS, MODES, ()),
    "gin_eps": ("gin", {"learn_eps": True}, ZOO_LAYERS, MODES, _SUM),
    "sgc": ("sgc", {"k": 2}, [128, 40], MODES, _CHAIN),
    "appnp": ("appnp", {"k": 10}, ZOO_LAYERS, MODES, _CHAIN),
    "gcn2": ("gcn2", {}, [128] + [256] * 8 + [40], MODES, _CHAIN),
    "gat1": ("gat", {"heads": 1}, ZOO_LAYERS, MODES, ()),
    "gat8": ("gat", {"heads": 8}, ZOO_LAYERS, ("mixed",), ()),
}
# the fp32 forward of a family with no kernel of its own against the
# same functions in float64, as a share of the logits' scale: fp32
# rounding through two layers of GEMMs, max or softmax-weighted sums.
# Its gradients, per weight as a share of the weight's largest: those
# sums again, then the weight gradients' sums over 169,343 rows, where
# entries far below the largest carry its rounding.  Where a piecewise
# op takes another branch in the two precisions (a ReLU input within
# rounding of 0; two neighbours' values within rounding of each other
# under MAX) the cotangent goes elsewhere, and under a random cotangent
# one such entry moves a weight's gradient by ~1/sqrt(V) of its largest;
# those entries of each ReLU's and MAX's output have their cotangent cut
# in both precisions before the gradients are compared (the uncut error
# is reported beside it).
FP64_TOL = 1e-4
FP64_GRAD_TOL = 1e-3
# The reference's Reddit settings (TRAIN) for every family but SAGE-pool,
# which takes lr 0.003: at 0.01 its train loss rose from epoch 4 to 9
# under dropout 0.5 on this graph while its train accuracy rose (the
# phase's lr_witness: on the ELL max, the edge-list max and in float64).
ZOO_LR = {"sage_pool": 0.003}


def _zoo_trainer(ds, impl, dropout, params=None, mode="float32", *, fam,
                 **cfg):
    """:func:`_trainer` for zoo family ``fam`` at its ``ZOO_LR``; mode
    'float64' is float64 throughout."""
    import torch
    from roc_tpu_torch.models import model_builders
    from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                             resolve_dtypes)
    name, kw, layers, _, _ = ZOO[fam]
    dtype, compute_dtype = ((torch.float64, None) if mode == "float64"
                            else resolve_dtypes(mode))
    train = dict(TRAIN, learning_rate=ZOO_LR.get(fam,
                                                 TRAIN["learning_rate"]))
    return Trainer(model_builders()[name](layers, dropout_rate=dropout,
                                          **kw), ds,
                   TrainConfig(aggr_impl=impl, symmetric=True, seed=SEED,
                               dtype=dtype, compute_dtype=compute_dtype,
                               **{**train, **cfg}),
                   params=params)


def _expected(fam, impl):
    """The kernels a run of ``fam`` on ``impl`` must launch."""
    return tuple("csr_spmm" if impl == "cuda_csr" and k == "ell_aggregate"
                 else k for k in ZOO[fam][4])


def zoo_launches(fam, counts):
    """:func:`train_slice`'s check of a run of zoo family ``fam``: the
    counts (:class:`Launches`) zeroed just before the run and read just
    after, then one eval alone, for the launches a step (the run's less
    its two evals', over its 10 steps).  Raises if a kernel the run must
    launch never ran, or another one did."""
    names = ("indegree_norm", "scale_act", "ell_aggregate", "csr_spmm")

    @contextlib.contextmanager
    def check(impl, mode, tr, rec):
        key = F32 if mode == "float32" else BF16
        counts.zero()
        yield
        launches = counts.read(key)
        counts.zero()
        tr.evaluate()
        evals = counts.peek()
        counts.zero()
        rec["launches"] = {k: launches[k][key] for k in names}
        rec["launches_per_step"] = {
            k: (launches[k][key] - 2 * evals[k][key]) / 10 for k in names}
        want = _expected(fam, impl)
        if [k for k in want if not launches[k][key]] or [
                k for k in names if k not in want
                and (launches[k][F32] or launches[k][BF16])] or any(
                launches[k][F32 if key == BF16 else BF16] for k in names):
            raise AssertionError(f"zoo {fam} {impl} {mode}: launches "
                                 f"{launches}, expected {want or 'none'}")
    return check


def _max_flips(torch, g, x32, out32, x64, out64, chunk=1 << 20):
    """The (row, feature) entries of a MAX's output whose maxima are
    different neighbours in fp32 (``x32``, ``out32``) and in float64:
    the set of neighbours equal to the row's maximum differs.  Over the
    graph's CSR edges in chunks."""
    dev = x32.device
    src = torch.from_numpy(g.col_idx.astype(np.int64)).to(dev)
    dst = torch.repeat_interleave(
        torch.arange(g.num_nodes, device=dev),
        torch.from_numpy(np.diff(g.row_ptr)).to(dev))
    flips = torch.zeros(out32.shape, dtype=torch.int32, device=dev)
    for e0 in range(0, src.numel(), chunk):
        s, d = src[e0:e0 + chunk], dst[e0:e0 + chunk]
        flips.index_add_(0, d, ((x32[s] == out32[d])
                                != (x64[s] == out64[d])).to(torch.int32))
    return flips > 0


def zoo_fp64(torch, ds, fam, params):
    """A family with no kernel of its own (MAX, attention): its fp32
    inference logits on 'cuda' against the same model in float64 on the
    plain 'ell' route, on the card, within ``FP64_TOL`` of max|logit|;
    and the gradients of the logits' product with a fixed random
    cotangent, fp32 against float64, each weight's within
    ``FP64_GRAD_TOL`` of its largest entry, with the cotangent cut in
    both precisions at each ReLU or MAX output entry that takes another
    branch in the two (a ReLU input's sign; :func:`_max_flips`); the
    uncut error and the share of each op's entries cut are reported."""
    from roc_tpu_torch.ops import dense
    from roc_tpu_torch.train.trainer import make_graph_context
    tr = _zoo_trainer(ds, "cuda", 0.0, params=params, fam=fam,
                      verbose=False)
    gctx64 = make_graph_context(ds, "ell", symmetric=True,
                                device=tr.device)
    gen = torch.Generator(device=tr.device).manual_seed(SEED + 5)
    ct = None
    relu = dense._ACTIVATIONS[dense.AC_MODE_RELU]

    def forward(dtype, gctx):
        """Logits, weights and each ReLU's and MAX's (kind, input,
        output) in op order."""
        nonlocal ct
        ops, inner = [], gctx._max_fwd

        def tap(kind, fn):
            def run(x):
                out = fn(x)
                ops.append((kind, x.detach(), out))
                return out
            return run
        gctx._max_fwd = tap("max", inner)
        dense._ACTIVATIONS[dense.AC_MODE_RELU] = tap("relu", relu)
        try:
            p = {k: v.detach().to(dtype).requires_grad_(True)
                 for k, v in tr.params.items()}
            logits = tr.model.apply(p, tr.feats.to(dtype), gctx,
                                    train=False)
        finally:
            del gctx._max_fwd
            dense._ACTIVATIONS[dense.AC_MODE_RELU] = relu
        if ct is None:
            ct = torch.randn(logits.shape, generator=gen, device=tr.device,
                             dtype=torch.float64)
        return logits, p, ops

    def grads(logits, p, ops, cut):
        hooks = [out.register_hook(lambda g, k=k: g.masked_fill(k, 0))
                 for (_, _, out), k in zip(ops, cut)]
        got = torch.autograd.grad((logits.double() * ct).sum(),
                                  list(p.values()), retain_graph=True)
        for h in hooks:
            h.remove()
        return dict(zip(p, got))

    def rel(a, b):
        return {k: float((a[k].double() - b[k]).abs().max())
                / float(b[k].abs().max()) for k in b}

    l32, p32, ops32 = forward(torch.float32, tr.gctx)
    l64, p64, ops64 = forward(torch.float64, gctx64)
    if [k for k, _, _ in ops32] != [k for k, _, _ in ops64]:
        raise AssertionError(f"zoo {fam}: the precisions ran other ops")
    got, want = l32.detach().double(), l64.detach()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    cut = [((x32 > 0) != (x64 > 0)) if kind == "relu" else
           _max_flips(torch, ds.graph, x32, o32.detach(), x64, o64.detach())
           for (kind, x32, o32), (_, x64, o64) in zip(ops32, ops64)]
    grad_err = rel(grads(l32, p32, ops32, cut), grads(l64, p64, ops64, cut))
    rec = {"max_abs_err": err, "logit_scale": scale, "tol": FP64_TOL,
           "grad_rel_err": grad_err, "grad_tol": FP64_GRAD_TOL}
    if cut:
        none = [torch.zeros_like(k) for k in cut]
        rec.update(
            entries_cut=[[kind, int(k.sum()), float(k.float().mean())]
                         for (kind, _, _), k in zip(ops32, cut)],
            grad_rel_err_uncut=rel(grads(l32, p32, ops32, none),
                                   grads(l64, p64, ops64, none)))
    if not (torch.isfinite(got).all() and err <= FP64_TOL * scale) or any(
            not e <= FP64_GRAD_TOL for e in grad_err.values()):
        raise AssertionError(f"zoo {fam}: fp32 against float64: {rec}")
    return rec


def lr_witness(torch, ds, fam):
    """Why ``fam`` trains below the reference's lr (``ZOO_LR``): 10
    epochs at lr 0.01, dropout 0.5, from SEED, on 'cuda' (the ELL max)
    and 'segment' (the edge-list max) in fp32 and on 'ell' in float64,
    all three from the first run's Glorot weights and dropout generator
    state; each run's eval lines at epochs 4 and 9, recorded and not
    gated."""
    from roc_tpu_torch.train.trainer import format_metrics
    out, start = {}, None
    for impl, mode in (("cuda", "float32"), ("segment", "float32"),
                       ("ell", "float64")):
        tr = _zoo_trainer(ds, impl, 0.5, mode=mode, fam=fam, epochs=10,
                          eval_every=5, verbose=False, params=start,
                          learning_rate=TRAIN["learning_rate"])
        if start is None:
            start = {k: v.detach().clone() for k, v in tr.params.items()}
            state = tr.generator.get_state()
        else:
            tr.generator.set_state(state)
        hist = tr.train()
        out[f"{impl}/{mode}"] = {
            "train_loss": [m["train_loss"] for m in hist],
            "infer": [format_metrics(m["epoch"], m) for m in hist]}
        del tr
        torch.cuda.empty_cache()
    return out


def zoo(torch, dev, entries, counts):
    """Phase 12: K1-K4 held to their plain versions at the zoo's input
    width F = 128 on the arxiv-shape graph (fp32 and bf16; the rows join
    each kernel's table entry as ``zoo_shapes``), then per family:
    parity (:func:`train_parity`, a family with a sum) or the float64
    forward and gradients (one without), the lr witness where the family
    trains below the reference's lr, the training runs
    (:func:`train_slice`; sum families on 'cuda' and 'cuda_csr', the
    others on 'cuda'; each mode of the family; the launches checked by
    :func:`zoo_launches` on ``counts``) and, with ``--deep``, a profile
    per mode (:func:`train_profile` on 'cuda') and the lr witness."""
    from roc_tpu_torch.core.graph import synthetic_dataset
    from roc_tpu_torch.core.partition import padded_edge_list
    from roc_tpu_torch.models import model_builders
    from roc_tpu_torch.train.trainer import make_graph_context
    t0 = time.perf_counter()
    ds = synthetic_dataset(ZOO_V, ZOO_DEGREE, in_dim=ZOO_LAYERS[0],
                           num_classes=ZOO_LAYERS[-1], seed=SEED,
                           name="arxiv_shape")
    g = ds.graph
    gctx = make_graph_context(ds, "cuda", symmetric=True)
    esrc, edst = (torch.from_numpy(a).to(dev)
                  for a in padded_edge_list(g, multiple=512))
    out = {"V": g.num_nodes, "E": g.num_edges, "dataset_s":
           time.perf_counter() - t0,
           "buckets": [list(a.shape) for a in gctx.ell_idx]}
    log({"phase": "zoo_data", **out})
    for key, dtype in ((F32, torch.float32), (BF16, torch.bfloat16)):
        adj = torch.sparse_csr_tensor(
            torch.from_numpy(g.row_ptr).to(dev),
            torch.from_numpy(g.col_idx.astype(np.int64)).to(dev),
            torch.ones(g.num_edges, device=dev, dtype=dtype),
            size=(g.num_nodes, g.num_nodes), check_invariants=False)
        got = kernel_checks(torch, dev, gctx, adj, g.num_edges, esrc, edst,
                            dtype, widths=((128, "none"),))
        for name, e in got.items():
            entries[key][name].setdefault("zoo_shapes", []).extend(
                e["shapes"])
        del adj
    del gctx, esrc, edst
    torch.cuda.empty_cache()
    out["families"] = {}
    for fam, (name, kw, layers, modes, kernels) in ZOO.items():
        t1 = time.perf_counter()
        make = functools.partial(_zoo_trainer, fam=fam)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        params = model_builders()[name](layers, **kw).init_params(
            gen, device=dev)
        params = {k: v.detach() for k, v in params.items()}
        rec = {"family": fam, "layers": layers, "kwargs": kw,
               "lr": ZOO_LR.get(fam, TRAIN["learning_rate"])}
        if kernels:
            rec["parity"] = [train_parity(torch, ds, params, m,
                                          make=make)[0] for m in modes]
        else:
            rec["fp64"] = zoo_fp64(torch, ds, fam, params)
        del params
        if fam in ZOO_LR and DEEP:
            rec["lr_witness"] = lr_witness(torch, ds, fam)
        routes = ("cuda", "cuda_csr") if kernels else ("cuda",)
        rec["train"] = train_slice(
            torch, ds, [(impl, mode) for mode in modes for impl in routes],
            make=make, check=zoo_launches(fam, counts))
        if DEEP:
            rec["profile"] = {mode: train_profile(
                torch, ds, mode, steps=2, make=make, impls=("cuda",))
                for mode in modes}
        torch.cuda.empty_cache()
        rec["seconds"] = time.perf_counter() - t1
        log({"phase": "zoo", **rec})
        out["families"][fam] = rec
    out["seconds"] = time.perf_counter() - t0
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


# Phase 13, the precomputed serving backend (roc_tpu_torch/serve/): the
# SGC 602-41 (k = 2) at Reddit's shape on its 'akx' table, the GCN on
# its 'table' flavor, both exported and cold-loaded, and the edge-append
# invalidation at the zoo's arxiv shape, where a 2-hop neighbourhood is
# small (at Reddit's degree it is most of the graph).
AKX_LAYERS = [602, 41]
AKX_HOPS = 2
AKX_EPOCHS = 20
SAMPLE = 4096
INVALIDATE_PAIRS = 8
# fp8-e4m3 keeps 3 mantissa bits: its export takes the relaxed gate the
# JAX package's tests give it (tests/test_serve_quant.py)
FP8_GATE = dict(drift_argmax_min=0.90, drift_dlogit_max=0.20)


def _rows_check(name, got, want, rtol):
    """``got`` within ``rtol * max(|want|, 1)`` of ``want`` (rtol 0:
    the same bits); logs and raises past it."""
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    ok = (bool(np.array_equal(got, want)) if rtol == 0
          else err <= rtol * max(scale, 1.0))
    rec = {"check": name, "max_abs_err": err, "rtol": rtol,
           "logit_scale": scale, "ok": ok}
    if not (ok and got.shape == want.shape and np.isfinite(got).all()):
        raise AssertionError(f"{name}: {rec}")
    return rec


def precompute_profile(torch, graph, ops, feats):
    """One more prefix walk (after the counted one) through a staging
    pool of its own, between two CUDA events (``event_span_ms``: its K3
    launches, its copies and the host's gaps between them; ``wall_ms``
    around it), with the pool's pinned H2D copies (bytes, device ms on
    the copy stream, GB/s) and overlap.  No torch.profiler session: after
    the earlier sessions of this process one lost every record (phase 15
    profiles the walk in a fresh process)."""
    from roc_tpu_torch.core.streaming import StagingPool, stream_prefix_to_host
    pool = StagingPool(depth=1, device=torch.device("cuda"))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    stream_prefix_to_host(graph, ops, feats, pool=pool)
    b.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    st = pool.take_stats()
    return {"event_span_ms": a.elapsed_time(b), "wall_ms": wall,
            "h2d_bytes": st["h2d_bytes"], "h2d_copy_ms": st["h2d_copy_ms"],
            "h2d_gbps": st["h2d_gbps"], "overlap_frac": st["overlap_frac"],
            "blocks": st["n"]}


def _sample(num_nodes, seed):
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(num_nodes, size=min(SAMPLE, num_nodes),
                              replace=False))


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_akx(torch, ds, counts, root):
    """The SGC's 'akx' predictor at Reddit's shape: the precompute (the
    blocked host walk, core/streaming.py) with the counts zeroed just
    before and read just after (K3 must run, and K1, K2 and K4 must not:
    the walk's norms are host row scales and its sums K3 tiles), its
    wall (with ``--deep`` its event span and pinned copies,
    :func:`precompute_profile`), the table
    bytes per mode, the logits of a sample against the same SGC on the
    full backend (fp32 within 1e-4, 'mixed' within 3e-2 of the scale),
    int8 through the export drift gate (defaults) and fp8 behind the
    relaxed one, and every request size through Predictor.query and
    Server beside the full backend's.  Returns the record and the int8
    predictor (exported to ``root``/akx_int8)."""
    import os
    import shutil
    from roc_tpu_torch.models.sgc import build_sgc
    from roc_tpu_torch.serve import quant
    from roc_tpu_torch.serve.export import build_predictor, export_predictor
    from roc_tpu_torch.serve.propagation import prefix_descriptors
    from roc_tpu_torch.serve.server import Server
    from roc_tpu_torch.train.trainer import TrainConfig, Trainer
    cfg = TrainConfig(aggr_impl="cuda", symmetric=True, seed=SEED)
    model = build_sgc(AKX_LAYERS, k=AKX_HOPS)
    # served weights are trained ones: on Glorot weights the 41 logits
    # sit within int8's noise of each other and argmaxes flip
    tr = Trainer(build_sgc(AKX_LAYERS, k=AKX_HOPS, dropout_rate=0.5), ds,
                 TrainConfig(aggr_impl="cuda", symmetric=True, seed=SEED,
                             epochs=AKX_EPOCHS, eval_every=AKX_EPOCHS,
                             verbose=False, **TRAIN))
    hist = tr.train()
    params = {k: v.detach().clone() for k, v in tr.params.items()}
    del tr
    torch.cuda.empty_cache()
    counts.zero()
    pred, wall = _timed(torch, lambda: build_predictor(model, ds, cfg,
                                                       params=params))
    launches = counts.read(F32)
    rec = {"V": ds.graph.num_nodes, "F": AKX_LAYERS[0], "hops": AKX_HOPS,
           "trained_epochs": AKX_EPOCHS,
           "train_acc": hist[-1]["train_acc"],
           "backend": pred.backend, "flavor": pred.flavor,
           "precompute_wall_s": wall, "launches": launches,
           "ops": pred.cache.ops}
    if pred.flavor != "akx" or not launches["csr_spmm"][F32] or any(
            launches[k][F32] for k in _CHAIN):
        raise AssertionError(f"serve_akx: the precompute's walk did not "
                             f"run K3 alone: {rec}")
    if DEEP:
        rec.update(precompute_profile(
            torch, ds.graph,
            prefix_descriptors(pred.model.precompute_split()[0]),
            ds.features))
        torch.cuda.empty_cache()
    shape = pred.cache.table.shape
    rec["table_bytes"] = {m: quant.table_bytes(shape, m)
                          for m in quant.QMODES}
    rec["device_table_bytes"] = {"off": pred.table_bytes()}
    ids = _sample(pred.num_nodes, SEED + 21)
    full = build_predictor(model, ds, cfg, params=params, backend="full")
    want = full.query(ids)
    checks = [_rows_check("akx_fp32_vs_full", pred.query(ids), want,
                          SERVE_TOL["float32"])]
    mixed = build_predictor(model, ds, dataclasses.replace(
        cfg, compute_dtype=torch.bfloat16), params=params, cache=pred.cache)
    checks.append(_rows_check("akx_mixed_vs_full_fp32", mixed.query(ids),
                              want, SERVE_TOL["mixed"]))
    lat = {"akx_query": request_times(pred.query, pred.num_nodes, SEED + 22),
           "akx_mixed_query": request_times(mixed.query, pred.num_nodes,
                                            SEED + 23),
           # the full backend's ~140 ms a request, the yardstick of the
           # akx table's, 5 times a size (20 cost ~11 s of the script)
           "full_query": request_times(full.query, pred.num_nodes,
                                       SEED + 24, reps=5)}
    with Server(pred, max_wait_ms=2.0, name="chip_smoke_akx") as srv:
        lat["akx_server"] = request_times(
            lambda i: srv.submit(i).result(timeout=300), pred.num_nodes,
            SEED + 25)
    del full, mixed
    torch.cuda.empty_cache()
    quantized = {}
    for mode, gate in (("int8", {}), ("fp8", FP8_GATE)):
        q = build_predictor(model, ds, cfg, params=params, cache=pred.cache,
                            quant=mode)
        out = os.path.join(root, f"akx_{mode}")
        man, export_s = _timed(torch, lambda: export_predictor(q, out,
                                                               **gate))
        rec[mode] = {"drift": man["quant"]["drift"],
                     "table": man["quant"]["table"], "export_s": export_s,
                     "gate": gate or "default"}
        rec["device_table_bytes"][mode] = q.table_bytes()
        # the gate's sample is 512 rows; this sample's drift, reported
        got = q.query(ids)
        rec[mode]["sample_drift"] = quant.drift_report(want, got)
        lat[f"akx_{mode}_query"] = request_times(q.query, pred.num_nodes,
                                                 SEED + 26)
        if not man["quant"]["drift"]["ok"]:
            raise AssertionError(f"serve_akx: {mode} failed its gate: "
                                 f"{man['quant']['drift']}")
        quantized[mode] = q
    shutil.rmtree(os.path.join(root, "akx_fp8"))
    rec["checks"] = checks
    del pred, quantized["fp8"]
    torch.cuda.empty_cache()
    return rec, lat, quantized["int8"], params


def serve_table(torch, ds, params, counts, root):
    """The 602-256-41 GCN (phase 4's weights) on the 'table' flavor in
    fp32 and 'mixed': the precompute (one forward: K1, K4, K2) with the
    counts zeroed just before and read just after, the served rows of a
    sample bit-equal to the full backend's, and each request size
    through Predictor.query and Server beside the full backend's through
    Predictor.query.  The fp32 predictor is exported to ``root``/table
    and returned."""
    import os
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.serve.export import build_predictor, export_predictor
    from roc_tpu_torch.serve.server import Server
    from roc_tpu_torch.train.trainer import TrainConfig
    rec, lat, keep = {}, {}, None
    for mode, key, compute in (("float32", F32, None),
                               ("mixed", BF16, torch.bfloat16)):
        cfg = TrainConfig(aggr_impl="cuda", symmetric=True, seed=SEED,
                          compute_dtype=compute)
        counts.zero()
        tab, wall = _timed(torch, lambda: build_predictor(
            build_gcn(LAYERS), ds, cfg, params=params,
            backend="precomputed"))
        launches = counts.read(key)
        r = {"flavor": tab.flavor, "precompute_wall_s": wall,
             "launches": launches, "device_table_bytes": tab.table_bytes()}
        if tab.flavor != "table" or not all(launches[k][key]
                                            for k in _CHAIN):
            raise AssertionError(f"serve_table {mode}: the forward did not "
                                 f"run K1, K4 and K2: {r}")
        full = build_predictor(build_gcn(LAYERS), ds, cfg, params=params,
                               backend="full")
        ids = _sample(tab.num_nodes, SEED + 31)
        r["checks"] = [_rows_check(f"table_{mode}_vs_full",
                                   tab.query(ids), full.query(ids), 0.0)]
        lat[f"table_{mode}_query"] = request_times(tab.query, tab.num_nodes,
                                                   SEED + 32)
        lat[f"full_{mode}_query"] = request_times(full.query, tab.num_nodes,
                                                  SEED + 33)
        with Server(tab, max_wait_ms=2.0, name="chip_smoke_table") as srv:
            lat[f"table_{mode}_server"] = request_times(
                lambda i: srv.submit(i).result(timeout=300), tab.num_nodes,
                SEED + 34)
        del full
        torch.cuda.empty_cache()
        if mode == "float32":
            _, r["export_s"] = _timed(torch, lambda: export_predictor(
                tab, os.path.join(root, "table")))
            keep = tab
        del tab
        rec[mode] = r
    return rec, lat, keep


def serve_artifact(torch, root, exported):
    """Each exported predictor (``exported``: artifact name -> the live
    predictor that wrote it) cold-loaded with load_predictor in this
    process: its load seconds, bytes on disk, and its served rows of a
    sample bit-equal to the exporting predictor's."""
    import os
    from roc_tpu_torch.serve.export import load_predictor
    rec = {}
    for name, pred in exported.items():
        path = os.path.join(root, name)
        cold, load_s = _timed(torch, lambda: load_predictor(path))
        ids = _sample(pred.num_nodes, SEED + 41)
        rec[name] = {
            "load_s": load_s, "qmode": cold.quant, "flavor": cold.flavor,
            "bytes_on_disk": sum(os.path.getsize(os.path.join(path, f))
                                 for f in os.listdir(path)),
            "check": _rows_check(f"{name}_cold_vs_export", cold.query(ids),
                                 pred.query(ids), 0.0)}
        del cold
    return rec


def serve_invalidate(torch, counts):
    """Edge appends at the zoo's arxiv shape (SGC 128-40, k = 2, phase
    12's data): INVALIDATE_PAIRS undirected edges appended on the host,
    the rows recomputed, host and publish ms; the new version's table
    against a rebuild on the mutated graph (within 1e-5 of the scale);
    a batch pinned to the old version served bit for bit; and int8
    published while a thread serves batches pinned to the fp32 version,
    each of them bit-exact."""
    import threading
    from roc_tpu_torch.core.graph import Graph, synthetic_dataset
    from roc_tpu_torch.models.sgc import build_sgc
    from roc_tpu_torch.serve.export import build_predictor
    from roc_tpu_torch.serve.propagation import PropagationCache
    from roc_tpu_torch.serve.server import Server
    from roc_tpu_torch.train.trainer import TrainConfig
    ds, data_s = _timed(torch, lambda: synthetic_dataset(
        ZOO_V, ZOO_DEGREE, in_dim=ZOO_LAYERS[0], num_classes=ZOO_LAYERS[-1],
        seed=SEED, name="arxiv_shape"))
    cfg = TrainConfig(aggr_impl="cuda", symmetric=True, seed=SEED)
    model = build_sgc([ZOO_LAYERS[0], ZOO_LAYERS[-1]], k=2)
    params = model.init_params(
        torch.Generator(device="cuda").manual_seed(SEED + 50), device="cuda")
    counts.zero()
    pred = build_predictor(model, ds, cfg, params=params)
    launches = counts.read(F32)
    V = pred.num_nodes
    rng = np.random.RandomState(SEED + 51)
    u = rng.randint(0, V, size=INVALIDATE_PAIRS)
    v = (u + 1 + rng.randint(0, V - 1, size=INVALIDATE_PAIRS)) % V
    src, dst = np.concatenate([u, v]), np.concatenate([v, u])
    ids = np.union1d(_sample(V, SEED + 52), src)
    pub0 = pred.published()
    want0 = pred.query(ids, pub=pub0)
    t0 = time.perf_counter()
    rows = pred.cache.add_edges(src, dst)
    host_ms = (time.perf_counter() - t0) * 1e3
    _, publish_s = _timed(torch, lambda: pred.refresh_rows(rows))
    pub1 = pred.published()
    g2 = Graph(row_ptr=pred.cache.row_ptr.copy(),
               col_idx=pred.cache.col_idx.copy())
    rebuilt = PropagationCache.build(g2, pred.cache.ops, ds.features)
    rec = {"V": V, "E": ds.graph.num_edges, "dataset_s": data_s,
           "launches": launches, "edges_appended": int(src.size),
           "rows_recomputed": int(rows.size), "host_ms": host_ms,
           "publish_ms": publish_s * 1e3,
           "versions": [pub0.version, pub1.version]}
    checks = [
        _rows_check("host_table_vs_rebuild", pred.cache.table,
                    rebuilt.table, 1e-5),
        _rows_check("device_table_vs_rebuild",
                    pub1.table[:V].float().cpu().numpy(), rebuilt.table,
                    1e-5),
        _rows_check("pinned_v0_after_invalidate",
                    pred.query(ids, pub=pub0), want0, 0.0)]
    want1 = pred.query(ids, pub=pub1)
    moved = int((np.abs(want1 - want0).max(axis=1) > 0).sum())
    if not moved or pub1.table is pub0.table:
        raise AssertionError(f"serve_invalidate: no served row moved: {rec}")
    pinned, errors = [], []
    started = threading.Event()

    def pinned_batches():
        try:
            for i in range(10):
                pinned.append(pred.query(ids, pub=pub1))
                started.set()
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)
            started.set()

    th = threading.Thread(target=pinned_batches)
    th.start()
    started.wait(timeout=60)
    v2 = pred.publish_quant("int8")
    th.join(timeout=120)
    if errors or th.is_alive():
        raise AssertionError(f"serve_invalidate: pinned batches failed: "
                             f"{errors}")
    with Server(pred, max_wait_ms=2.0, name="chip_smoke_inval") as srv:
        res = srv.submit(ids).result(timeout=300)
    checks.append({"check": "pinned_fp32_during_int8_publish",
                   "batches": len(pinned),
                   "ok": all(np.array_equal(p, want1) for p in pinned)})
    if not checks[-1]["ok"]:
        raise AssertionError(f"serve_invalidate: {checks[-1]}")
    checks.append(_rows_check("int8_after_publish_vs_fp32", np.asarray(res),
                              want1, 0.02))
    rec.update(rows_moved_in_sample=moved, quant_version=v2,
               server_version=res.version, server_qmode=res.qmode,
               checks=checks)
    if (res.version, res.qmode) != (v2, "int8"):
        raise AssertionError(f"serve_invalidate: the Server answered "
                             f"v{res.version}:{res.qmode}")
    return rec


def serve_precomputed(torch, ds, gcn_params, counts):
    """Phase 13: :func:`serve_akx`, :func:`serve_table`,
    :func:`serve_artifact` and :func:`serve_invalidate`, each logged as
    its phase line (request times in a line of their own).  Returns the
    SGC's trained weights (phase 18 serves them)."""
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        rec, lat, akx8, akx_params = serve_akx(torch, ds, counts, root)
        log({"phase": "serve_akx", **rec})
        log({"phase": "serve_akx_requests", **lat})
        rec, lat, tab = serve_table(torch, ds, gcn_params, counts, root)
        log({"phase": "serve_table", **rec})
        log({"phase": "serve_table_requests", **lat})
        log({"phase": "serve_artifact",
             **serve_artifact(torch, root, {"akx_int8": akx8,
                                            "table": tab})})
        del akx8, tab
        torch.cuda.empty_cache()
    log({"phase": "serve_invalidate", **serve_invalidate(torch, counts)})
    torch.cuda.empty_cache()
    return akx_params


# ---------------------------------------------------------------------------
# 14. The large-graph layouts (sectioned, flat_sum, bdense, attn_flat8),
# the native host planners, vertex reordering and aggr_impl='auto'
# ---------------------------------------------------------------------------

# the races' routes: (name, aggr_impl, graph_context keywords)
RACE_ROUTES = (("cuda", "cuda", {}), ("cuda_csr", "cuda_csr", {}),
               ("sectioned", "sectioned", {}),
               ("sectioned_u16", "sectioned", {"sect_u16": True}),
               ("flat_sum", "flat_sum", {}))
# the block-dense substrate: planted communities of 16,384 rows in their
# own order at Reddit's V, its edge count cut from 114,848,857 for the
# phase's time; a tile of a community holds ~80 edges at this E
PLANTED_ROWS = 16_384
PLANTED_E = 23_000_000
BD = dict(bdense_min_fill=32, bdense_a_budget=6 << 30)
# the GCN's block-dense plan at Reddit's shape: min_fill 32 (a uniform
# graph's tile holds ~34 edges, none reaches the default 64) and the
# default 2 GiB budget
BD_TRAIN = dict(bdense_min_fill=32)
# the reorder check: the arxiv shape's V and E, communities of 4,096 rows
REORDER_ROWS = 4_096
ZOO_E = 4_730_941
# ogbn-products' shape: V, the degree that gives E ~ 126 M after the
# reverse edges and self edges, the 100-256-47 widths
PRODUCTS_V = 2_449_029
PRODUCTS_DEGREE = 52
PRODUCTS_LAYERS = [100, 256, 47]
# the layouts' training runs: epochs a run (2 steady steps after the
# first), and the timed calls a route takes in the races (K3 and K4 take
# RACE_KERNEL_N; the races are not gates, and were cut from 2 and 10 to
# keep the whole script well inside its time limit)
LAYOUT_EPOCHS = 3
RACE_N, RACE_KERNEL_N = 1, 4
# 3 steps of GAT on 'attn_flat8' against the plain 'ell' route: its
# softmax-weighted sums in another order and bf16 activations rounded at
# other places, over two layers and 3 Adam steps
LAYOUT_PLAIN_RTOL = {"mixed": 2e-2}


def _native_calls():
    from roc_tpu_torch import native
    return dict(native.calls)


def _native_ran(before, names):
    """Raise unless each native entry point of ``names`` ran since
    ``before`` (the card run must not drop to numpy unseen)."""
    from roc_tpu_torch import native
    if not native.available():
        raise AssertionError("the native host planners did not build")
    missing = [n for n in names
               if native.calls.get(n, 0) <= before.get(n, 0)]
    if missing:
        raise AssertionError(f"the native planners never ran: {missing}")


def _kernel_launches(counts, key, fn):
    """K3's and K4's launches by one call of ``fn`` (not counted in the
    table: a race's launches are comparisons)."""
    counts.zero()
    fn()
    got = counts.peek()
    counts.zero()
    return {k: got[k][key] for k in ("ell_aggregate", "csr_spmm")}


def _race_one(torch, counts, gctx, route, x, want, n):
    """One route's forward sum of ``x``: held to K4's ``want``
    (:func:`sum_check`), its launches of K3 and K4 a call, event ms and
    device ms."""
    key = BF16 if x.dtype == torch.bfloat16 else F32
    with torch.inference_mode():
        got = gctx._sum_fwd(x)
        ok, err = sum_check(torch, got, want)
        if not ok:
            raise AssertionError(f"{route} {x.dtype} F={x.shape[1]}: "
                                 f"max_abs_err {err} against K4")
        del got
        launches = _kernel_launches(counts, key, lambda: gctx._sum_fwd(x))
        want_k = {"cuda": "ell_aggregate", "cuda_csr": "csr_spmm"}.get(route)
        if any(launches[k] for k in launches if k != want_k) or (
                want_k and not launches[want_k]):
            raise AssertionError(f"{route}: K3/K4 launches {launches}")
        return {"max_abs_err": err, "launches_per_call": launches,
                "ms": time_ms(torch, lambda: gctx._sum_fwd(x), n),
                "device_ms": device_ms(torch, lambda: gctx._sum_fwd(x), n)}


def layout_race(torch, ds, counts):
    """Races at Reddit's shape: the forward sum at F = 256 and F = 41, in
    fp32 and bf16, on K4 ('cuda'), K3 ('cuda_csr'), the sectioned tables
    (sub_w 8, int32 and uint16 ids) and the flat tables; each held to
    K4 (:func:`sum_check`), with its host build seconds (the native
    planners for the layouts), event and device ms and K3/K4 launches a
    call (K4 on 'cuda' alone, K3 on 'cuda_csr' alone, none on the
    layouts)."""
    from roc_tpu_torch.train.trainer import graph_context
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    before = _native_calls()
    ctxs, build_s = {}, {}
    for name, impl, kw in RACE_ROUTES:
        t0 = time.perf_counter()
        ctxs[name] = graph_context(ds.graph, impl, symmetric=True,
                                   device=dev, **kw)
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
    _native_ran(before, ("sectioned_counts", "sectioned_fill"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    rows = []
    for F in (256, 41):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((V, F), generator=gen, device=dev).to(dtype)
            with torch.inference_mode():
                want = ctxs["cuda"]._sum_fwd(x)
            rec = {"F": F, "dtype": str(dtype)}
            for name, _, _ in RACE_ROUTES:
                n = RACE_KERNEL_N if name.startswith("cuda") else RACE_N
                rec[name] = _race_one(torch, counts, ctxs[name],
                                      name.split("_u16")[0], x, want, n)
            k4 = rec["cuda"]["ms"]
            for name, _, _ in RACE_ROUTES:
                rec[name]["over_k4"] = rec[name]["ms"] / k4
            log({"phase": "layouts_race", **rec})
            rows.append(rec)
            del x, want
    out = {"build_s": build_s, "rows": rows,
           "seconds": time.perf_counter() - t_start,
           "sect_shapes": [list(a.shape) for a in ctxs["sectioned"].sect_idx],
           "flat_shape": list(ctxs["flat_sum"].flat8_idx.shape)}
    del ctxs
    torch.cuda.empty_cache()
    return out


def _unpacked(torch, gctx):
    """The block-dense context with its u4 A-table unpacked to uint8
    (the same multiplicities)."""
    a = gctx.bd_a
    a = torch.stack([a & 0xF, a >> 4], dim=-1).reshape(a.shape[0], 128, 128)
    return dataclasses.replace(gctx, bd_a=a)


def bdense_race(torch, counts):
    """The block-dense route on planted communities in their own order
    (V = Reddit's, E = PLANTED_E): the probe's dense share, each plan's
    seconds, blocks and A bytes at group 1 and 16, u4 packed and not,
    and its forward sum at F = 256 in fp32 and bf16 against K4 and the
    sectioned tables, each held to K4."""
    from roc_tpu_torch.core.graph import planted_community_csr
    from roc_tpu_torch.ops.blockdense import probe_dense_frac
    from roc_tpu_torch.train.trainer import graph_context
    dev = torch.device("cuda")
    t_start = t0 = time.perf_counter()
    g = planted_community_csr(V, PLANTED_E, community_rows=PLANTED_ROWS,
                              shuffle=False, seed=SEED)
    out = {"V": g.num_nodes, "E": g.num_edges, "community_rows":
           PLANTED_ROWS, "generate_s": time.perf_counter() - t0, **BD}
    before = _native_calls()
    t0 = time.perf_counter()
    out["probe_dense_frac"] = probe_dense_frac(
        g.row_ptr, g.col_idx, g.num_nodes, min_fill=BD["bdense_min_fill"],
        a_budget_bytes=BD["bdense_a_budget"])
    out["probe_s"] = time.perf_counter() - t0
    ctxs = {}
    for name, impl, kw in (("cuda", "cuda", {}), ("sectioned", "sectioned",
                                                 {}),
                           ("bdense_g1", "bdense", dict(BD, bdense_group=1)),
                           ("bdense_g16", "bdense",
                            dict(BD, bdense_group=16))):
        t0 = time.perf_counter()
        ctxs[name] = graph_context(g, impl, symmetric=True, device=dev, **kw)
        torch.cuda.synchronize()
        out[f"{name}_build_s"] = time.perf_counter() - t0
        if impl == "bdense":
            c = ctxs[name]
            if c.bd_a is None:
                raise AssertionError(f"{name}: the plan has no block")
            out[f"{name}_plan"] = {
                "n_blocks": int(c.bd_a.shape[0]),
                "a_bytes_u4": int(c.bd_a.numel()),
                "a_bytes_u8": 2 * int(c.bd_a.numel()),
                "residual_sections": len(c.sect_idx)}
            ctxs[name + "_u8"] = _unpacked(torch, c)
    _native_ran(before, ("block_counts", "block_fill", "sectioned_counts",
                         "sectioned_fill"))
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    out["rows"] = []
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((V, 256), generator=gen, device=dev).to(dtype)
        with torch.inference_mode():
            want = ctxs["cuda"]._sum_fwd(x)
        rec = {"F": 256, "dtype": str(dtype)}
        for name, c in ctxs.items():
            route = name if name in ("cuda", "sectioned") else "bdense"
            rec[name] = _race_one(torch, counts, c, route, x, want,
                                  RACE_KERNEL_N if name == "cuda" else RACE_N)
            rec[name]["over_k4"] = rec[name]["ms"] / rec["cuda"]["ms"]
        log({"phase": "layouts_bdense", **rec})
        out["rows"].append(rec)
        del x, want
    del ctxs, g
    out["seconds"] = time.perf_counter() - t_start
    torch.cuda.empty_cache()
    return out


def reorder_check():
    """A shuffled planted-community graph at the arxiv shape relabeled
    by lpa and by bfs: seconds and the dense share (the probe, bdense's
    min_fill and budget) of the shuffled, reordered and oracle orders."""
    from roc_tpu_torch.core.graph import planted_community_csr
    from roc_tpu_torch.core.reorder import ORDERINGS, apply_graph_order
    from roc_tpu_torch.ops.blockdense import probe_dense_frac

    def frac(g):
        return probe_dense_frac(g.row_ptr, g.col_idx, g.num_nodes,
                                min_fill=BD["bdense_min_fill"],
                                a_budget_bytes=BD["bdense_a_budget"])
    t_start = time.perf_counter()
    kw = dict(community_rows=REORDER_ROWS, seed=SEED)
    shuffled = planted_community_csr(ZOO_V, ZOO_E, shuffle=True, **kw)
    out = {"V": ZOO_V, "E": ZOO_E, "community_rows": REORDER_ROWS,
           "dense_frac": {"shuffled": frac(shuffled), "oracle": frac(
               planted_community_csr(ZOO_V, ZOO_E, shuffle=False, **kw))}}
    before = _native_calls()
    for name in ("lpa", "bfs"):
        t0 = time.perf_counter()
        perm = ORDERINGS[name](shuffled)
        out[f"{name}_s"] = time.perf_counter() - t0
        out["dense_frac"][name] = frac(apply_graph_order(shuffled, perm))
    _native_ran(before, ("lpa_iterate",))
    if not out["dense_frac"]["lpa"] >= 0.9 * out["dense_frac"]["oracle"]:
        raise AssertionError(f"lpa did not recover the communities: {out}")
    out["seconds"] = time.perf_counter() - t_start
    log({"phase": "layouts_reorder", **out})
    return out


def _layout_trainer(ds, impl, dropout, params=None, mode="float32", *,
                    fam=None, layers=LAYERS, **cfg):
    """A Trainer of the GCN (``fam`` None) or of a model_builders family
    ``(name, kwargs)`` on ``impl``, the reference's Reddit settings, the
    block-dense route at ``BD``."""
    from roc_tpu_torch.models import model_builders
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train.trainer import (TrainConfig, Trainer,
                                             resolve_dtypes)
    dtype, compute_dtype = resolve_dtypes(mode)
    if fam is None:
        model = build_gcn(layers, dropout_rate=dropout)
    else:
        model = model_builders()[fam[0]](layers, dropout_rate=dropout,
                                         **fam[1])
    return Trainer(model, ds, TrainConfig(
        aggr_impl=impl, symmetric=True, seed=SEED, dtype=dtype,
        compute_dtype=compute_dtype, **TRAIN,
        **(BD_TRAIN if impl == "bdense" else {}), **cfg), params=params)


@contextlib.contextmanager
def shared_contexts():
    """Trainers built inside share one graph context per (dataset,
    route, keywords), so a layout's host plan and upload happen once
    for its parity and training runs (a context holds tables only)."""
    from roc_tpu_torch.train import trainer as T
    real, cache = T.make_graph_context, {}

    def make(dataset, aggr_impl, **kw):
        key = (id(dataset), aggr_impl, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = real(dataset, aggr_impl, **kw)
        return cache[key]
    T.make_graph_context = make
    try:
        yield
    finally:
        T.make_graph_context = real
        cache.clear()


def _layout_steps(torch, make, ds, impl, mode, params, steps=3):
    """``steps`` steps, dropout 0, from ``params``, one eval after them:
    the objectives, the route the trainer resolved, the steady steps'
    ``epoch_ms``, and for a block-dense context its blocks and dense
    share."""
    tr = make(ds, impl, 0.0, params=params, mode=mode, eval_every=steps,
              verbose=False)
    hist = tr.train(steps)
    tr.sync()
    info = {"route": tr.config.aggr_impl, "epoch_ms": hist[0]["epoch_ms"],
            "first_step_ms": hist[0]["first_step_ms"]}
    a = tr.gctx.bd_a
    if tr.config.aggr_impl == "bdense":
        if a is None:
            raise AssertionError(f"{impl}: the block-dense plan has no block")
        dense = int((a & 0xF).sum()) + int((a >> 4).sum())
        info.update(n_blocks=int(a.shape[0]),
                    dense_frac=dense / ds.graph.num_edges)
    losses = torch.stack(tr.losses).double().cpu().numpy()
    del tr, a
    torch.cuda.empty_cache()
    return losses, info


def _layout_epochs(torch, make, ds, impl, mode, epochs=LAYOUT_EPOCHS):
    """``epochs`` epochs, dropout 0.5, one eval at the end: its
    ``epoch_ms`` (steady steps), ``first_step_ms``, and with ``--deep``
    the device ms of one more step under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    tr = make(ds, impl, 0.5, mode=mode, epochs=epochs, eval_every=epochs,
              verbose=False)
    hist = tr.train()
    tr.sync()
    losses = torch.stack(tr.losses).double().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{impl} {mode}: non-finite loss {losses}")
    us = 0
    if DEEP:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tr.train(1)
            tr.sync()
        us = sum(e.device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        del prof
    rec = {"route": tr.config.aggr_impl, "epoch_ms": hist[0]["epoch_ms"],
           "first_step_ms": hist[0]["first_step_ms"],
           "device_ms_per_step": us / 1e3 if us > 0 else "not measured",
           "train_loss": hist[0]["train_loss"]}
    del tr
    torch.cuda.empty_cache()
    return rec


def _held(got, info, ref, base, rtol):
    """A route's objectives ``got`` against ``base``'s ``ref``."""
    rel = float((np.abs(got - ref) / np.abs(ref)).max())
    if not (np.isfinite(got).all() and rel <= rtol):
        raise AssertionError(f"{info['route']}: losses {got} against "
                             f"{base}'s {ref} (rtol {rtol})")
    return {**info, "losses": got.tolist(), f"{base}_losses": ref.tolist(),
            "max_rel_err": rel, "rtol": rtol}


def _counted(counts, key, fn):
    """``fn()`` as a counted main-path run: the counts zeroed just
    before and read (into the table) just after."""
    counts.zero()
    out = fn()
    return out, counts.read(key)


def reddit_train(torch, ds, counts):
    """The 602-256-41 GCN at Reddit's shape on 'sectioned', 'flat_sum'
    and 'bdense' (``BD``): 3 parity steps against 'cuda' (the smoke's
    gates, PARITY_RTOL) in fp32 and mixed, their steady steps'
    ``epoch_ms`` (the dropout-0.5 epochs, timed in earlier runs of this
    script, PERF.md §5, are left out for phase 18's time); and what
    'auto' resolves to on this card (its row in core/ell.py)."""
    from roc_tpu_torch.core.ell import jax_auto_impl, port_route
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train.trainer import (TrainConfig, card_kind,
                                             resolve_config)
    dev = torch.device("cuda")
    kind = card_kind(dev)
    _, cfg = resolve_config(build_gcn(LAYERS), ds,
                            TrainConfig(aggr_impl="auto", symmetric=True),
                            device=dev)
    rule = jax_auto_impl(V, None, ds.graph.num_edges)
    auto = {"kind": kind, "resolved": cfg.aggr_impl, "jax_rule": rule,
            "row_route": port_route(rule, kind)}
    log({"phase": "layouts_auto", **auto})
    if cfg.aggr_impl != auto["row_route"]:
        raise AssertionError(f"'auto' resolved to {cfg.aggr_impl}; the "
                             f"card's row names {auto['row_route']}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = {k: v.detach() for k, v in build_gcn(LAYERS).init_params(
        gen, device=dev).items()}
    out = {"auto": auto, "routes": {}}
    t0 = time.perf_counter()
    before = _native_calls()
    for mode, key in (("float32", F32), ("mixed", BF16)):
        (ref, _), launches = _counted(counts, key, lambda: _layout_steps(
            torch, _layout_trainer, ds, "cuda", mode, params))
        if not (all(launches[k][key] for k in ("indegree_norm", "scale_act",
                                                 "ell_aggregate"))
                and launches["indegree_norm_masked"]):
            raise AssertionError(f"cuda {mode}: a kernel of the fused chain "
                                 f"never ran: {launches}")
        for impl in ("sectioned", "flat_sum", "bdense"):
            got, info = _layout_steps(torch, _layout_trainer, ds, impl, mode,
                                      params)
            rec = {"mode": mode, "route": impl,
                   "parity": _held(got, info, ref, "cuda",
                                   PARITY_RTOL[mode])}
            log({"phase": "layouts_train", **rec})
            out["routes"][f"{impl}/{mode}"] = rec
    _native_ran(before, ("sectioned_counts", "sectioned_fill",
                         "block_counts", "block_fill"))
    out["seconds"] = time.perf_counter() - t0
    return out


def products_dataset():
    """ogbn-products' shape from SEED: the symmetric synthetic graph,
    features ``[V, 100]``, labels of 47 classes, half the rows training
    rows."""
    from roc_tpu_torch.core.graph import Dataset, MASK_TRAIN, synthetic_graph
    g = synthetic_graph(PRODUCTS_V, PRODUCTS_DEGREE, seed=SEED)
    rng = np.random.RandomState(SEED)
    C = PRODUCTS_LAYERS[-1]
    return Dataset(
        g, rng.randn(PRODUCTS_V, PRODUCTS_LAYERS[0]).astype(np.float32),
        rng.randint(0, C, PRODUCTS_V).astype(np.int32),
        np.where(rng.rand(PRODUCTS_V) < 0.5, MASK_TRAIN, 0).astype(np.int32),
        C, name="products_shape")


def products(torch, counts, products_dir=None):
    """ogbn-products' shape (symmetric synthetic_graph, V = 2,449,029,
    E ~ 126 M; mapped from :func:`prep_datasets`'s files in
    ``products_dir``, else built here): GIN
    100-256-47: 'auto' resolved to the card row's route ('cuda' on the
    H100, so it is not run again), 'flat_sum' 3 parity steps against
    'cuda', and LAYOUT_EPOCHS counted epochs on 'cuda', in fp32 and mixed
    (the epochs of 'auto' and 'flat_sum', timed in earlier runs of this
    script, are left out for phase 18's time);
    GAT (1 head, mixed) on 'attn_flat8', 3 steps against 3 on the plain
    'ell' route (LAYOUT_PLAIN_RTOL); SAGE-pool (fp32) on 'flat_sum''s
    max, its logits against 'ell''s, then 3 steps; each run's steady
    steps' epoch_ms; the peak memory."""
    from roc_tpu_torch.models import model_builders
    from roc_tpu_torch.ops.attention import resolve_dh_chunk
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if products_dir is not None:
        ds = _map_dataset(products_dir, PRODUCTS_LAYERS[-1],
                          name="products_shape", mmap=False)
    else:
        ds = products_dataset()
    g = ds.graph
    out = {"V": g.num_nodes, "E": g.num_edges,
           "dataset_s": time.perf_counter() - t0,
           "mapped": products_dir is not None}
    log({"phase": "layouts_products_data", **out})
    fams = {"gin": ("gin", {}), "gat": ("gat", {"heads": 1}),
            "sage_pool": ("sage", {"aggregator": "pool"})}

    def make(fam):
        return functools.partial(_layout_trainer, fam=fams[fam],
                                 layers=PRODUCTS_LAYERS)

    def init(fam):
        name, kw = fams[fam]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return {k: v.detach() for k, v in model_builders()[name](
            PRODUCTS_LAYERS, **kw).init_params(gen, device=dev).items()}

    from roc_tpu_torch.core.ell import jax_auto_impl, port_route
    from roc_tpu_torch.train.trainer import (TrainConfig, card_kind,
                                             resolve_config)
    name, kw = fams["gin"]
    _, cfg = resolve_config(model_builders()[name](PRODUCTS_LAYERS, **kw),
                            ds, TrainConfig(aggr_impl="auto",
                                            symmetric=True), device=dev)
    rule = jax_auto_impl(PRODUCTS_V, None, g.num_edges)
    out["auto"] = {"resolved": cfg.aggr_impl, "jax_rule": rule,
                   "row_route": port_route(rule, card_kind(dev))}
    if cfg.aggr_impl != out["auto"]["row_route"]:
        raise AssertionError(f"products 'auto': {out['auto']}")
    params = init("gin")
    for mode, key in (("float32", F32), ("mixed", BF16)):
        rec = out[f"gin/{mode}"] = {}
        (ref, _), _ = _counted(counts, key, lambda: _layout_steps(
            torch, make("gin"), ds, "cuda", mode, params))
        for impl in ("flat_sum",):
            got, info = _layout_steps(torch, make("gin"), ds, impl, mode,
                                      params)
            rec[impl] = {"parity": _held(got, info, ref, "cuda",
                                         PARITY_RTOL[mode])}
        for impl in ("cuda",):
            run, launches = _counted(counts, key, lambda: _layout_epochs(
                torch, make("gin"), ds, impl, mode))
            rec.setdefault(impl, {}).update(train=run, launches=launches)
            k = {"cuda": "ell_aggregate"}.get(run["route"])
            if any(launches[n][key] for n in ("ell_aggregate", "csr_spmm")
                   if n != k) or (k and not launches[k][key]):
                raise AssertionError(f"gin {impl} on {run['route']}: "
                                     f"launches {launches}")
        log({"phase": "layouts_products_gin", "mode": mode, **rec})
    del params
    # GAT: 3 steps on 'attn_flat8' held to 3 on 'ell' (each run's steady
    # steps give its epoch_ms)
    params = init("gat")
    ref, ell = _layout_steps(torch, make("gat"), ds, "ell", "mixed", params)
    got, info = _layout_steps(torch, make("gat"), ds, "attn_flat8", "mixed",
                              params)
    out["gat"] = {"mode": "mixed", "parity": _held(
        got, info, ref, "ell", LAYOUT_PLAIN_RTOL["mixed"]), "ell": ell,
        "dh_chunk": [resolve_dh_chunk(PRODUCTS_V, 1, d)
                     for d in PRODUCTS_LAYERS[1:]]}
    log({"phase": "layouts_products_gat", **out["gat"]})
    del params
    # SAGE-pool: the ELL max keeps every gathered segment for its backward
    # (~E * F * 4 bytes, past the card's 80 GB here), so 'ell' is held to
    # in the forward: the logits at the same weights (a max is exact, so
    # the same bits up to the dense ops' order, 1e-5 of the logit scale);
    # then 3 steps on 'flat_sum'
    params = init("sage_pool")
    tr = make("sage_pool")(ds, "ell", 0.0, params=params, verbose=False)
    ref = tr.predict().float()
    del tr
    tr = make("sage_pool")(ds, "flat_sum", 0.0, params=params, verbose=False)
    err = float((tr.predict().float() - ref).abs().max())
    scale = float(ref.abs().max())
    del tr, ref
    torch.cuda.empty_cache()
    if not err <= 1e-5 * max(scale, 1.0):
        raise AssertionError(f"sage_pool flat_sum logits {err} off 'ell''s "
                             f"(scale {scale})")
    got, info = _layout_steps(torch, make("sage_pool"), ds, "flat_sum",
                              "float32", params)
    if not np.isfinite(got).all():
        raise AssertionError(f"sage_pool flat_sum: losses {got}")
    out["sage_pool"] = {"mode": "float32", "logits_max_abs_err_vs_ell": err,
                        "logit_scale": scale, "losses": got.tolist(), **info,
                        "ell_train": "not run: its backward needs ~E*F*4 "
                                     "bytes of kept segments at this shape"}
    log({"phase": "layouts_products_sage_pool", **out["sage_pool"]})
    del params
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.perf_counter() - t0
    return out


def layouts_child(data_dir, num_classes, out_path, products_dir=None):
    """Phase 14 in a fresh process on card 0 (the Reddit shape's files in
    ``data_dir``, the products shape's in ``products_dir``, else built
    here): with ``--deep`` the races at Reddit's shape and the
    block-dense race; the reorder check, the GCN on the layouts, the
    products shape; writes the record and the counts to
    ``out_path``."""
    import torch
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    _build.library()
    counts = Launches(torch)
    t0 = time.perf_counter()
    ds = _map_dataset(data_dir, num_classes)
    rec = {}

    def section(name, fn, *args):
        t1 = time.perf_counter()
        rec[name] = fn(*args)
        log({"phase": "layouts_section", "name": name,
             "seconds": time.perf_counter() - t1})

    if DEEP:
        section("race", layout_race, torch, ds, counts)
    with shared_contexts():
        section("train", reddit_train, torch, ds, counts)
    del ds
    if DEEP:
        section("bdense", bdense_race, torch, counts)
    section("reorder", reorder_check)
    with shared_contexts():
        section("products", products, torch, counts, products_dir)
    rec["seconds"] = time.perf_counter() - t0
    log({"phase": "layouts_seconds", **{k: v.get("seconds") for k, v in
                                         rec.items() if isinstance(v, dict)},
         "total": rec["seconds"]})
    with open(out_path, "w") as f:
        json.dump({"record": rec, "counted": counts.counted}, f)


# ---------------------------------------------------------------------------
# 15. The memory tier (core/streaming.py, core/memory.py): host-resident
# features through the pinned staging pool and the streamed head, the
# blocked host walk on K3, rematerialisation and the memory autopilot
# ---------------------------------------------------------------------------

MEM_EPOCHS = 10
MEM_MODES = (("float32", F32), ("mixed", BF16))
# remat recomputes the same forward with the same masks: its weights
# after 3 steps within this rtol of no remat's (the same bits expected)
REMAT_RTOL = 1e-5
REMAT_POLICIES = (("none", {}), ("full", dict(remat=True,
                                              remat_policy="full")),
                  ("save_aggregates", dict(remat=True,
                                           remat_policy="save_aggregates")))
# the edge chunk of the walk's tiles (core/streaming.py aggregate_to_host)
WALK_EDGE_CHUNK = 1 << 20
# the drills' stall deadline (ROC_TPU_STALL_TIMEOUT_S), seconds
STALL_S = 5


def _mem_run(torch, ds, mode, dropout, epochs, params, eval_every=None,
             fam=None, layers=LAYERS, **cfg):
    """``epochs`` epochs on 'cuda' from ``params`` (:func:`_layout_trainer`,
    the reference's Reddit settings) with the card's peak memory read
    around the run (the trainer's setup included): the objectives, the
    eval records, the final weights, the resolved plan and its modeled
    bytes."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = _layout_trainer(ds, "cuda", dropout, params=params, mode=mode,
                         fam=fam, layers=layers, epochs=epochs,
                         eval_every=eval_every or epochs, verbose=False,
                         **cfg)
    hist = tr.train()
    tr.sync()
    out = {"losses": torch.stack(tr.losses).double().cpu().numpy(),
           "hist": hist, "params": {k: v.detach().clone()
                                    for k, v in tr.params.items()},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "modeled_gb": tr.modeled_bytes / 1e9,
           "plan": {"features": tr.config.features,
                    "remat": tr.config.remat,
                    "remat_policy": tr.config.remat_policy}}
    del tr
    torch.cuda.empty_cache()
    return out


def _rel(got, ref):
    return float((np.abs(got - ref) / np.abs(ref)).max())


def _same(torch, a, b):
    return all(bool(torch.equal(a[k], b[k])) for k in a)


def _max_rel_w(a, b):
    """The largest weight difference over its weight's largest entry."""
    return max(float((a[k] - b[k]).abs().max() / b[k].abs().max())
               for k in b)


def _steady(run):
    """The last eval record's timing and pipeline fields."""
    m = run["hist"][-1]
    return {k: m.get(k) for k in (
        "epoch_ms", "first_step_ms", "overlap_frac", "h2d_wait_p50_ms",
        "h2d_stage_p50_ms", "h2d_gbps", "prefetch_depth", "spans_p50_ms")
        if k in m}


def walk_k3_check(torch, ds):
    """K3 at the blocked walk's shape: the first edge chunk of the first
    tile (dst block 0, src block 0) over a 65,536-row source block at
    F = 602 fp32, against its plain version (:func:`sum_check`), two
    launches for equal bits; kernel, plain and torch.sparse.mm (the
    chunk as a CSR) timed, and every slice width held to the plain
    version (raced with ``--deep``); the bound counts
    the source rows the chunk reads, its ids and its output once."""
    from roc_tpu_torch.core.streaming import BLOCK_ROWS, build_tile_plans
    from roc_tpu_torch.kernels import slicing, spmm
    from roc_tpu_torch.kernels._build import kernel_ops
    dev = torch.device("cuda")
    F = LAYERS[0]
    t0 = time.perf_counter()
    tiles = build_tile_plans(ds.graph, BLOCK_ROWS)
    tile_s = time.perf_counter() - t0
    t = tiles[0][0]
    src, dst, _, rows = next(iter(t.dev_chunks(WALK_EDGE_CHUNK, dev,
                                               cache=False)))
    block = torch.from_numpy(np.ascontiguousarray(
        ds.features[t.src_lo:t.src_lo + t.src_rows], dtype=np.float32)
    ).to(dev)
    real = src != t.src_rows
    n_real = int(real.sum())
    got = spmm.csr_spmm(block, src, dst, rows)
    if not torch.equal(got, spmm.csr_spmm(block, src, dst, rows)):
        raise AssertionError("walk K3: two launches differ")
    want = spmm.csr_spmm_plain(block, src, dst, rows)
    ok, err = sum_check(torch, got, want)
    if not ok:
        raise AssertionError(f"walk K3 F={F}: max_abs_err {err}")
    row_ptr = torch.searchsorted(dst[real].contiguous(),
                                 torch.arange(rows + 1, device=dev,
                                              dtype=torch.int32))
    adj = torch.sparse_csr_tensor(
        row_ptr, src[real].long(), torch.ones(n_real, device=dev),
        size=(rows, t.src_rows), check_invariants=False)
    n_src = int(torch.unique(src[real]).numel())
    nbytes = 4 * (n_src * F + rows * F) + 8 * int(src.numel())
    b, by = bound_ms(nbytes, kernel_ops("csr_spmm", rows, n_real, F))
    row = {"kernel": "csr_spmm", "dtype": "torch.float32",
           "shape": [t.src_rows, F, int(src.numel()), rows,
                     f"slice_cols={spmm.default_slice_cols(F)}"],
           "max_abs_err": err, "ok": ok,
           "ms": time_ms(torch, lambda: spmm.csr_spmm(block, src, dst, rows),
                         10),
           "plain_ms": time_ms(torch, lambda: spmm.csr_spmm_plain(
               block, src, dst, rows), 3),
           "library_ms": time_ms(torch, lambda: torch.sparse.mm(adj, block),
                                 10),
           "library_call": "torch.sparse.mm(chunk_csr, block)",
           "bound_ms": b, "bound_by": by, "tiles": sum(
               len(v) for v in tiles.values()), "tile_plan_s": tile_s,
           "chunk_edges": n_real, "source_rows_read": n_src}
    # every slice width at this shape, each held to the plain version
    # (with --deep a race; not a counted run)
    race = {}
    for S in slicing.SLICE_COLS:
        ok, err = sum_check(torch, spmm.csr_spmm(block, src, dst, rows,
                                                 slice_cols=S), want)
        if not ok:
            raise AssertionError(f"walk K3 slice_cols={S}: {err}")
        if DEEP:
            race[str(S)] = time_ms(torch, lambda S=S: spmm.csr_spmm(
                block, src, dst, rows, slice_cols=S), 10)
    row["slice_race_ms"] = race if DEEP else "with --deep"
    log({"phase": "memory_walk_k3", **row})
    del tiles, block, got, want, adj
    torch.cuda.empty_cache()
    return row


def walk_profile(torch, ds):
    """The SGC prefix (k = 2) through the blocked walk once more under
    torch.profiler: its wall, its device time by kind (K3 launches,
    host-to-device and device-to-host copies, the rest) and the share of
    copies, and its staging pool's pinned copies."""
    from torch.profiler import ProfilerActivity, profile
    from roc_tpu_torch.core.streaming import StagingPool, stream_prefix_to_host
    from roc_tpu_torch.models.sgc import build_sgc
    from roc_tpu_torch.serve.propagation import prefix_descriptors
    ops = prefix_descriptors(build_sgc(AKX_LAYERS, k=AKX_HOPS)
                             .precompute_split()[0])
    pool = StagingPool(depth=1, device=torch.device("cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stream_prefix_to_host(ds.graph, ops, ds.features, pool=pool)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by = {"k3_ms": 0.0, "h2d_ms": 0.0, "d2h_ms": 0.0, "other_ms": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.device_time_total / 1e3
        name = e.key.lower()
        key = ("h2d_ms" if "htod" in name else "d2h_ms" if "dtoh" in name
               else "k3_ms" if "csr" in name else "other_ms")
        by[key] += ms
    dev_ms = sum(by.values())
    st = pool.take_stats()
    return {"wall_ms": wall, "device_ms": dev_ms if dev_ms > 0 else
            "not measured", **by,
            "copy_share": ((by["h2d_ms"] + by["d2h_ms"]) / dev_ms
                           if dev_ms > 0 else None),
            "pool_h2d_bytes": st["h2d_bytes"],
            "pool_h2d_copy_ms": st["h2d_copy_ms"],
            "pool_h2d_gbps": st["h2d_gbps"],
            "overlap_frac": st["overlap_frac"], "blocks": st["n"]}


def _union(intervals):
    """Sorted, merged ``[start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def copy_overlap(torch, ds, mode, params):
    """The device's view of staging overlap (the trainer's overlap_frac
    is the host's: on the card a stage only issues its copy): one
    steady streamed step (features='host', dropout 0.5, after 2 warm
    ones) under torch.profiler, and the share of the host-to-device
    copies' device time during which a kernel ran on the card.  Reports
    "not measured" if the profiler sees no copies or no kernels."""
    from torch.profiler import ProfilerActivity, profile
    tr = _layout_trainer(ds, "cuda", 0.5, params=params, mode=mode,
                         eval_every=10 ** 6, verbose=False, features="host")
    tr.train(2)
    tr.sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train(1)
        tr.sync()
    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        iv = (e.time_range.start, e.time_range.end)
        name = e.name.lower()
        if "memcpy" in name or "memset" in name:
            if "htod" in name:
                copies.append(iv)
        elif not name.startswith("nccl:"):
            kernels.append(iv)
    del tr, prof
    torch.cuda.empty_cache()
    copy_us = sum(b - a for a, b in copies)
    if copy_us <= 0 or not kernels:
        return {"device_overlap_frac": "not measured",
                "h2d_copies": len(copies), "kernels": len(kernels)}
    busy = _union(kernels)
    hidden = 0.0
    for a, b in copies:
        for c, d in busy:
            if c >= b:
                break
            hidden += max(0.0, min(b, d) - max(a, c))
    return {"device_overlap_frac": hidden / copy_us,
            "h2d_copies": len(copies), "h2d_device_ms": copy_us / 1e3,
            "h2d_hidden_ms": hidden / 1e3, "kernels": len(kernels)}


def streamed_gcn(torch, ds, counts, params):
    """The 602-256-41 GCN with features='host' on 'cuda', fp32 and mixed:
    3 parity steps at dropout 0 against features='hbm' from the same
    weights (PARITY_RTOL); 3 steps at dropout 0.5 with prefetch 1 and 0,
    the same bits; then, with the counts zeroed just before and read just
    after each, MEM_EPOCHS epochs at dropout 0.5 (the train loss falls
    from epoch 4 to 9; K1, the masked K1, K2 and K4 ran) on the host tier
    and on 'hbm': epoch_ms, the pipeline fields, peak and modeled
    memory."""
    out = {}
    for mode, key in MEM_MODES:
        rec = out[mode] = {}
        hbm = _mem_run(torch, ds, mode, 0.0, 3, params)
        host = _mem_run(torch, ds, mode, 0.0, 3, params, features="host")
        rel = _rel(host["losses"], hbm["losses"])
        rec["parity"] = {"losses": host["losses"].tolist(),
                         "hbm_losses": hbm["losses"].tolist(),
                         "max_rel_err": rel, "rtol": PARITY_RTOL[mode]}
        if not (np.isfinite(host["losses"]).all()
                and rel <= PARITY_RTOL[mode]):
            raise AssertionError(f"streamed gcn {mode}: {rec['parity']}")
        p = {d: _mem_run(torch, ds, mode, 0.5, 3, params, features="host",
                         prefetch=d) for d in (1, 0)}
        rec["prefetch_bitequal"] = _same(torch, p[0]["params"],
                                         p[1]["params"]) \
            and bool(np.array_equal(p[0]["losses"], p[1]["losses"]))
        if not rec["prefetch_bitequal"]:
            raise AssertionError(f"streamed gcn {mode}: prefetch 1 and 0 "
                                 f"differ")
        for tag, kw in (("host", dict(features="host")), ("hbm", {})):
            counts.zero()
            run = _mem_run(torch, ds, mode, 0.5, MEM_EPOCHS, params,
                           eval_every=5, **kw)
            launches = counts.read(key)
            loss = [m["train_loss"] for m in run["hist"]]
            if not (all(launches[k][key] for k in _CHAIN)
                    and launches["indegree_norm_masked"]) or \
                    not loss[-1] < loss[0]:
                raise AssertionError(f"streamed gcn {mode} {tag}: train "
                                     f"loss {loss}, launches {launches}")
            rec[tag] = {"train_loss": loss, **_steady(run),
                        "peak_gb": run["peak_gb"],
                        "modeled_gb": run["modeled_gb"],
                        "launches": launches}
        if DEEP:
            rec["host"]["device_overlap"] = copy_overlap(torch, ds, mode,
                                                         params)
        log({"phase": "memory_streamed_gcn", "mode": mode, **rec})
    return out


def streamed_sgc(torch, ds, counts):
    """The SGC 602-41 (k = 2) with features='host': the trainer's prefix
    walk with the counts zeroed just before and read just after (K3 ran,
    K1, K2 and K4 did not), its setup wall; the walk profiled
    (:func:`walk_profile`); 3 parity steps at dropout 0 against
    features='hbm' from the same weights (fp32, PARITY_RTOL)."""
    from roc_tpu_torch.models.sgc import build_sgc
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    params = {k: v.detach() for k, v in build_sgc(
        AKX_LAYERS, k=AKX_HOPS).init_params(gen, device="cuda").items()}
    fam = ("sgc", {"k": AKX_HOPS})
    counts.zero()
    t0 = time.perf_counter()
    host = _mem_run(torch, ds, "float32", 0.0, 3, params, fam=fam,
                    layers=AKX_LAYERS, features="host")
    wall = time.perf_counter() - t0
    launches = counts.read(F32)
    if not launches["csr_spmm"][F32] or any(launches[k][F32]
                                            for k in _CHAIN):
        raise AssertionError(f"streamed sgc: the walk did not run K3 "
                             f"alone: {launches}")
    hbm = _mem_run(torch, ds, "float32", 0.0, 3, params, fam=fam,
                   layers=AKX_LAYERS)
    rel = _rel(host["losses"], hbm["losses"])
    rec = {"setup_and_3_steps_s": wall, "launches": launches,
           "parity": {"losses": host["losses"].tolist(),
                      "hbm_losses": hbm["losses"].tolist(),
                      "max_rel_err": rel, "rtol": PARITY_RTOL["float32"]},
           "host": {**_steady(host), "peak_gb": host["peak_gb"],
                    "modeled_gb": host["modeled_gb"]},
           "hbm": {**_steady(hbm), "peak_gb": hbm["peak_gb"],
                   "modeled_gb": hbm["modeled_gb"]}}
    if not (np.isfinite(host["losses"]).all()
            and rel <= PARITY_RTOL["float32"]):
        raise AssertionError(f"streamed sgc: {rec['parity']}")
    if DEEP:
        rec["walk"] = walk_profile(torch, ds)
    log({"phase": "memory_streamed_sgc", **rec})
    return rec


def _remat_set(torch, ds, counts, key, mode, params, tag,
               peak_must_fall=False, **kw):
    """3 steps at dropout 0.5 from ``params`` per remat policy, the counts
    zeroed just before and read just after the set: each run's weights
    against no remat's (REMAT_RTOL; bit-equal reported), epoch_ms and
    peak memory; with ``peak_must_fall`` each remat peak must be below
    no remat's."""
    counts.zero()
    runs = {name: _mem_run(torch, ds, mode, 0.5, 3, params, **kw, **pk)
            for name, pk in REMAT_POLICIES}
    launches = counts.read(key)
    rec = {"launches": launches}
    ref = runs["none"]
    for name, run in runs.items():
        rel = _max_rel_w(run["params"], ref["params"])
        rec[name] = {"epoch_ms": run["hist"][-1]["epoch_ms"],
                     "first_step_ms": run["hist"][-1]["first_step_ms"],
                     "peak_gb": run["peak_gb"],
                     "modeled_gb": run["modeled_gb"],
                     "weights_max_rel_err": rel,
                     "bit_equal": _same(torch, run["params"],
                                        ref["params"])}
        if not rel <= REMAT_RTOL:
            raise AssertionError(f"remat {tag} {mode} {name}: weights "
                                 f"{rel} off no remat's")
        if peak_must_fall and name != "none" and \
                not run["peak_gb"] < ref["peak_gb"]:
            raise AssertionError(f"remat {tag} {mode} {name}: peak "
                                 f"{run['peak_gb']} GB not below no "
                                 f"remat's {ref['peak_gb']}")
    if not launches["ell_aggregate"][key]:
        raise AssertionError(f"remat {tag} {mode}: K4 never ran: "
                             f"{launches}")
    log({"phase": "memory_remat", "model": tag, "mode": mode, **rec})
    return rec


def remat_gcn(torch, ds, counts, params):
    """The GCN at Reddit's shape in fp32 and mixed, for remat none, full
    and save_aggregates (:func:`_remat_set`)."""
    return {mode: _remat_set(torch, ds, counts, key, mode, params, "gcn")
            for mode, key in MEM_MODES}


def remat_products(torch, counts, products_dir):
    """GIN 100-256-47 at the products shape (the prep's graph, from
    ``products_dir``) on 'cuda' in fp32, for remat none, full and
    save_aggregates (:func:`_remat_set`)."""
    from roc_tpu_torch.models.gin import build_gin
    pds = _map_dataset(products_dir, PRODUCTS_LAYERS[-1],
                       name="products_shape")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = {k: v.detach() for k, v in build_gin(
        PRODUCTS_LAYERS).init_params(gen, device="cuda").items()}
    return {"V": pds.graph.num_nodes, "E": pds.graph.num_edges,
            "float32": _remat_set(torch, pds, counts, F32, "float32",
                                  params, "gin_products", fam=("gin", {}),
                                  layers=PRODUCTS_LAYERS,
                                  peak_must_fall=True)}


def autopilot(torch, ds, counts, params):
    """memory='auto' at Reddit's shape: the detected budget picks
    gather/hbm; budgets from the port's own estimate_plan_bytes pick
    remat (the remat plan's bytes) and the host tier (the host plan's);
    3 steps each with the counts zeroed just before and read just after,
    the plan, its modeled bytes and the measured peak."""
    from roc_tpu_torch.core.memory import detect_hbm_bytes, estimate_plan_bytes
    V_, E = ds.graph.num_nodes, ds.graph.num_edges
    budgets = {"detected": (None, ("hbm", False)),
               "remat": (estimate_plan_bytes(V_, E, LAYERS, remat=True),
                         ("hbm", True)),
               "host": (estimate_plan_bytes(V_, E, LAYERS, features="host"),
                        ("host", False))}
    out = {"detected_budget_gb": detect_hbm_bytes("cuda") / 1e9}
    for name, (budget, want) in budgets.items():
        counts.zero()
        run = _mem_run(torch, ds, "float32", 0.5, 3, params, memory="auto",
                       hbm_bytes=budget)
        launches = counts.read(F32)
        got = (run["plan"]["features"], run["plan"]["remat"])
        out[name] = {"budget_gb": None if budget is None else budget / 1e9,
                     "plan": run["plan"], "modeled_gb": run["modeled_gb"],
                     "peak_gb": run["peak_gb"],
                     "epoch_ms": run["hist"][-1]["epoch_ms"],
                     "losses": run["losses"].tolist(),
                     "launches": launches}
        if got != want or not np.isfinite(run["losses"]).all():
            raise AssertionError(f"autopilot {name}: picked {got}, want "
                                 f"{want}: {out[name]}")
    log({"phase": "memory_autopilot", **out})
    return out


def drills(torch, counts):
    """The streamed tier's drill sites at the arxiv shape (GCN 128-256-40,
    features='host', dropout 0 as the JAX drills: a retry reseeds the
    masks), the counts zeroed just before and read just after: the
    uninterrupted run, then staging_io:2 under train_with_recovery (one
    OSError, one restore-and-retry, the uninterrupted run's bits), then
    stall_compile:0 with ROC_TPU_STALL_TIMEOUT_S (a StallFailure out of
    train_with_recovery before its first checkpoint, then the restart
    finishes)."""
    import os
    import tempfile
    from roc_tpu_torch.core.graph import synthetic_dataset
    from roc_tpu_torch.obs.events import get_bus
    from roc_tpu_torch.obs.heartbeat import StallFailure
    from roc_tpu_torch.resilience import inject
    from roc_tpu_torch.resilience.recovery import (CheckpointRotation,
                                                   train_with_recovery)
    ds = synthetic_dataset(ZOO_V, ZOO_DEGREE, in_dim=ZOO_LAYERS[0],
                           num_classes=ZOO_LAYERS[-1], seed=SEED,
                           name="arxiv_shape")
    bus = get_bus()

    def make(**kw):
        return _layout_trainer(ds, "cuda", 0.0, layers=ZOO_LAYERS,
                               features="host", epochs=4, eval_every=2,
                               verbose=False, **kw)

    def recover(tr, root):
        n = len(bus.ring)
        err = None
        try:
            train_with_recovery(tr, 4, CheckpointRotation(root, keep=3),
                                checkpoint_every=2)
        except StallFailure as e:
            err = e
        recs = list(bus.ring)[n:]
        return err, ([r["site"] for r in recs if r.get("kind") == "fault"],
                     [r["error"] for r in recs if r.get("kind") == "recovery"])

    inject.disarm()
    counts.zero()
    out = {"V": ds.graph.num_nodes, "E": ds.graph.num_edges}
    clean = make()
    clean.train()
    with tempfile.TemporaryDirectory() as tmp:
        tr = make(fault="staging_io:2")
        err, (fired, retried) = recover(tr, os.path.join(tmp, "a"))
        same = err is None and _same(torch, tr.params, clean.params)
        out["staging_io"] = {"fired": fired, "retried": retried,
                             "bit_equal": same}
        if fired != ["staging_io"] or retried != ["OSError"] or not same:
            raise AssertionError(f"staging_io drill: {out}")
        inject.disarm()
        os.environ["ROC_TPU_STALL_TIMEOUT_S"] = str(STALL_S)
        try:
            t0 = time.perf_counter()
            err, (fired, retried) = recover(make(fault="stall_compile:0"),
                                            os.path.join(tmp, "b"))
            stall_s = time.perf_counter() - t0
        finally:
            del os.environ["ROC_TPU_STALL_TIMEOUT_S"]
            inject.disarm()
        again = make()
        err2, (fired2, retried2) = recover(again, os.path.join(tmp, "b"))
        out["stall_compile"] = {"error": repr(err), "fired": fired,
                                "seconds_to_stall_failure": stall_s,
                                "restart_epoch": again.epoch,
                                "restart_retries": retried2}
        if not isinstance(err, StallFailure) or fired != ["stall_compile"] \
                or err2 is not None or again.epoch != 4:
            raise AssertionError(f"stall_compile drill: {out}")
    out["launches"] = counts.read(F32)
    log({"phase": "memory_drills", **out})
    return out


def memory_child(data_dir, products_dir, num_classes, out_path):
    """Phase 15 in a fresh process on card 0: K3 at the walk's shape,
    the streamed GCN and SGC, remat, the autopilot and the drills (the
    Reddit-shape dataset the parent saved in ``data_dir``, the products
    shape in ``products_dir``); writes the record, the counts
    and K3's walk row to ``out_path``."""
    import torch
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    _build.library()
    counts = Launches(torch)
    t0 = time.perf_counter()
    ds = _map_dataset(data_dir, num_classes)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = {k: v.detach() for k, v in build_gcn(LAYERS).init_params(
        gen, device="cuda").items()}
    rec = {}

    def section(name, fn, *args):
        t1 = time.perf_counter()
        rec[name] = fn(*args)
        log({"phase": "memory_section", "name": name,
             "seconds": time.perf_counter() - t1})

    section("walk_k3", walk_k3_check, torch, ds)
    with shared_contexts():
        section("streamed_gcn", streamed_gcn, torch, ds, counts, params)
        section("streamed_sgc", streamed_sgc, torch, ds, counts)
        section("autopilot", autopilot, torch, ds, counts, params)
        section("remat_gcn", remat_gcn, torch, ds, counts, params)
    del ds
    torch.cuda.empty_cache()
    with shared_contexts():
        section("remat_products", remat_products, torch, counts,
                products_dir)
    torch.cuda.empty_cache()
    section("drills", drills, torch, counts)
    rec["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"record": rec, "counted": counts.counted}, f)


# ---------------------------------------------------------------------------
# 16. The partitioned trainer's rest (parallel/ring.py, core/costmodel.py,
# the partitioned layouts): gloo ranks on this card
# ---------------------------------------------------------------------------

RING_STEPS = 3
# the 'mixed' logits of the ring against the gather's, as a share of
# max|logit| (SERVE_TOL's 'mixed': bf16 activations rounded at other
# places, and the ring adds its hops' bf16 sums)
RING_MIXED_LOGIT_TOL = 3e-2
# a forced repartition's weights against the run that never
# repartitions (its objectives: PARITY_RTOL): tests/test_torch_
# distributed.py's tolerance for a partitioned run against another split
# (fp32 sums in another order; Adam moves a weight by ~lr whatever its
# gradient's size, so a near-zero gradient amplifies rounding)
REBALANCE_WEIGHT_TOL = dict(rtol=2e-4, atol=2e-5)
# the forced repartition moves the first boundary by this share of the
# first part's rows (the cost split of a graph of uniform degree is
# balanced already: no measured time moves it)
FORCED_SHIFT = 0.1
# the arxiv-shape graph of the partitioned layouts: planted communities
# (symmetrised, self edges) so that 'bdense' has dense tiles
RING_LAYOUTS = ("sectioned", "flat_sum", "bdense")


def _ring_run(torch, ds, impl, mode, params, parts, steps=RING_STEPS,
              layers=LAYERS, before=None, **cfg):
    """A DistributedTrainer of ``parts`` ranks on card 0, dropout 0 from
    ``params``, ``before(trainer)`` when given, then ``steps`` steps each
    synchronised: the trainer, its objectives and the steady steps' mean
    wall ms."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.parallel.distributed import DistributedTrainer
    from roc_tpu_torch.train.trainer import TrainConfig, resolve_dtypes
    dtype, compute_dtype = resolve_dtypes(mode)
    tr = DistributedTrainer(
        build_gcn(layers, dropout_rate=0.0), ds, parts, TrainConfig(
            aggr_impl=impl, symmetric=True, seed=SEED, dtype=dtype,
            compute_dtype=compute_dtype, eval_every=10 ** 6, verbose=False,
            **TRAIN, **cfg), params=params, device=torch.device("cuda", 0))
    if before is not None:
        before(tr)
    ms = []
    for _ in range(steps):
        t = time.perf_counter()
        tr.train(1)
        tr.sync()
        ms.append((time.perf_counter() - t) * 1e3)
    losses = torch.stack(tr.losses).double().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"{impl} {mode} {cfg}: losses {losses}")
    return tr, losses, float(np.mean(ms[1:])) if steps > 1 else ms[0]


def _ring_hop_checks(torch, tr):
    """This rank's ring against its plain versions and its padding: each
    pair's row ranges end at its real edges and its padding sources the
    dummy row alone (so K3 reads no padding), and K3 at each hop's shape
    (the pair's edges into ``part_nodes`` rows from a ``part_nodes``-row
    buffer, the precomputed row ranges) against its plain version
    (:func:`sum_check`) at F = 256 and 41, fp32 and bf16, with its event
    ms, bound, plain and library (``torch.sparse.mm`` of the pair) times.
    Two ranks share the card: the times are a layout check."""
    from roc_tpu_torch.kernels import spmm
    from roc_tpu_torch.kernels._build import kernel_ops
    from roc_tpu_torch.parallel.ring import RING_MULTIPLE
    d, pn, dev = tr.data, tr.plan.part_nodes, tr.device
    real = np.asarray(d.ring_real)
    rp = d.ring_row_ptr.cpu().numpy()
    src = d.ring_src.cpu().numpy()
    S, pe = src.shape
    if d.ring_dst is not None:
        raise AssertionError(f"rank {tr.rank}: the kernel route uploaded "
                             "ring_dst")
    # the plain version's dst, as the row ranges encode it (the kernel
    # reads the ranges alone)
    dst = torch.stack([spmm.dst_from_row_ptr(d.ring_row_ptr[s], pe)
                       for s in range(S)])
    for s in range(S):
        n = int(real[s])
        if not (rp[s, -1] == n and (src[s, :n] < pn).all()
                and (src[s, n:] == pn).all()):
            raise AssertionError(f"rank {tr.rank} pair {s}: the row ranges "
                                 f"cover a padding slot ({rp[s, -1]} of "
                                 f"{n} real edges, {pe} slots)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11 + tr.rank)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        esize = 2 if dtype == torch.bfloat16 else 4
        for F in (256, 41):
            x = torch.randn((pn, F), generator=gen, device=dev).to(dtype)
            for s in range(S):
                args = (x, d.ring_src[s], dst[s], pn)
                n = int(real[s])

                def kern():
                    return spmm.csr_spmm(x, d.ring_src[s], None, pn,
                                         chunk=RING_MULTIPLE,
                                         row_ptr=d.ring_row_ptr[s])
                got = kern()
                want = spmm.csr_spmm_plain(*args)
                ok, err = sum_check(torch, got, want)
                if not (ok and torch.equal(got, kern())):
                    raise AssertionError(f"rank {tr.rank}: K3 at hop pair "
                                         f"{s}, F={F}, {dtype}: max_abs_err "
                                         f"{err}")
                adj = torch.sparse_csr_tensor(
                    d.ring_row_ptr[s], d.ring_src[s][:n].long(),
                    torch.ones(n, device=dev, dtype=dtype), size=(pn, pn),
                    check_invariants=False)
                b, by = bound_ms(2 * pn * F * esize + n * 4
                                 + (pn + 1) * 8,
                                 kernel_ops("csr_spmm", pn, n, F))
                try:
                    lib = time_ms(torch, lambda: torch.sparse.mm(adj, x), 3)
                except RuntimeError:
                    lib = None
                rows.append({"kernel": "csr_spmm", "pair": s, "F": F,
                             "dtype": str(dtype), "edges": n, "slots": pe,
                             "rows": pn, "max_abs_err": err,
                             "ms": time_ms(torch, kern, 3),
                             "plain_ms": time_ms(
                                 torch, lambda: spmm.csr_spmm_plain(*args),
                                 1),
                             "library_ms": lib, "bound_ms": b,
                             "bound_by": by})
            del x
    torch.cuda.synchronize()
    return rows


class _EventSink(list):
    """The event bus's records, through a sink of its own."""
    write = list.append


def _close_logits(a, b, tol):
    """``(ok, max_abs_err, atol)``: logits ``a`` within ``tol`` of
    max|b| of ``b``."""
    err = float(np.abs(a - b).max())
    atol = tol * max(float(np.abs(b).max()), 1.0)
    return bool(a.shape == b.shape and np.isfinite(a).all()
                and err <= atol), err, atol


def _ring_p2(torch, ds, counts, arxiv_dir):
    """One rank's part of phase 16 at P = 2 (see :func:`ring_child`)."""
    from roc_tpu_torch.core.costmodel import cost_balanced_bounds
    from roc_tpu_torch.core.memory import estimate_plan_bytes
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.obs.events import get_bus
    rank = torch.distributed.get_rank()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = {k: v.detach() for k, v in build_gcn(LAYERS).init_params(
        gen, device="cuda").items()}
    out: Dict[str, Any] = {}
    runs: Dict[str, Any] = {}

    def counted(tag, key, fn):
        counts.zero()
        got = fn()
        runs[tag] = {"launches": counts.read(key)}
        return got

    # the ring in fp32, overlap on: its tables and hop kernels checked,
    # then 3 counted steps, K3 at every hop and no pre-pass
    tr, losses, ms = counted("ring_fp32", F32, lambda: _ring_run(
        torch, ds, "cuda", "float32", params, 2, halo="ring"))
    d = tr.data
    # the ring's device tables: the kernel routes upload no ring_dst
    out["ring"] = {"pair_edges": d.pair_edges, "real": d.ring_real.tolist(),
                   "table_bytes": sum(
                       t.numel() * t.element_size()
                       for t in (d.ring_src, d.ring_dst, d.ring_row_ptr)
                       if t is not None),
                   "dst_uploaded": d.ring_dst is not None,
                   "padding_ratio": d.ring_padding_ratio,
                   "bounds": [list(map(int, b)) for b in tr.plan.bounds],
                   "part_nodes": tr.plan.part_nodes}
    n = runs["ring_fp32"]["launches"]
    hops = 2 * 4 * RING_STEPS      # 2 hops x 2 aggregations x fwd + bwd
    if not (n["csr_spmm"][F32] == hops and n["csr_row_ptr"] == 0
            and n["ell_aggregate"][F32] == 0 and n["indegree_norm"][F32]
            and n["scale_act"][F32] and n["indegree_norm_masked"]):
        raise AssertionError(f"rank {rank}: the ring's launches {n}, want "
                             f"K3 {hops} times and no pre-pass")
    ring_logits = tr.predict().float().cpu().numpy()
    ring_params = {k: v.detach().clone() for k, v in tr.params.items()}
    out["hop_checks"] = _ring_hop_checks(torch, tr)
    runs["ring_fp32"].update(losses=losses.tolist(), step_ms=ms)
    del tr
    torch.cuda.empty_cache()
    # overlap off: the same bits
    tr, off, ms = counted("ring_fp32_sequential", F32, lambda: _ring_run(
        torch, ds, "cuda", "float32", params, 2, halo="ring",
        ring_overlap=False))
    same = bool(np.array_equal(off, losses)) and all(
        torch.equal(tr.params[k], ring_params[k]) for k in ring_params)
    runs["ring_fp32_sequential"].update(losses=off.tolist(), step_ms=ms,
                                        same_bits=same)
    if not same:
        raise AssertionError(f"rank {rank}: overlap off {off} is not "
                             f"overlap on's {losses}")
    del tr
    torch.cuda.empty_cache()
    # the gather on the same split through 'auto' (the card's row), its
    # split the cost model's
    sink = _EventSink()
    get_bus().add_sink(sink)
    try:
        tr, glosses, ms = counted("gather_auto_fp32", F32, lambda: _ring_run(
            torch, ds, "auto", "float32", params, 2))
    finally:
        get_bus().sinks.remove(sink)
    (res,) = [e for e in sink if e["cat"] == "resolve"]
    want_bounds = [list(map(int, b)) for b in cost_balanced_bounds(
        ds.graph.row_ptr, 2, 8, tr.config.chunk)]
    ok, err, atol = _close_logits(tr.predict().float().cpu().numpy(),
                                  ring_logits, PREDICT_TOL)
    rel = np.abs(losses - glosses) / np.abs(glosses)
    runs["gather_auto_fp32"].update(
        losses=glosses.tolist(), step_ms=ms, route=tr.config.aggr_impl,
        jax_resolves=res.get("jax_resolves"), resolve=res["msg"],
        bounds=[list(map(int, b)) for b in tr.plan.bounds],
        ring_max_rel_loss_err=float(rel.max()),
        ring_logits_max_abs_err=err, ring_logits_atol=atol)
    if not (tr.config.aggr_impl == "cuda"
            and runs["gather_auto_fp32"]["launches"]["ell_aggregate"][F32]
            and runs["gather_auto_fp32"]["bounds"] == want_bounds
            == out["ring"]["bounds"]
            and rel.max() <= PARITY_RTOL["float32"] and ok):
        raise AssertionError(f"rank {rank}: ring against gather/auto: "
                             f"{runs['gather_auto_fp32']}, cost bounds "
                             f"{want_bounds}")
    gather_params = {k: v.detach().clone() for k, v in tr.params.items()}
    modeled = {"gather": tr.modeled_bytes}
    del tr
    torch.cuda.empty_cache()
    # 'mixed': the ring against the gather
    got = {}
    for halo in ("ring", "gather"):
        tr, ml, ms = counted(f"{halo}_mixed", BF16, lambda: _ring_run(
            torch, ds, "cuda", "mixed", params, 2, halo=halo))
        got[halo] = (ml, tr.predict().float().cpu().numpy())
        runs[f"{halo}_mixed"].update(losses=ml.tolist(), step_ms=ms)
        del tr
        torch.cuda.empty_cache()
    rel = np.abs(got["ring"][0] - got["gather"][0]) / np.abs(got["gather"][0])
    ok, err, atol = _close_logits(got["ring"][1], got["gather"][1],
                                  RING_MIXED_LOGIT_TOL)
    runs["ring_mixed"].update(max_rel_loss_err=float(rel.max()),
                              logits_max_abs_err=err, logits_atol=atol)
    if not (rel.max() <= PARITY_RTOL["mixed"] and ok
            and runs["ring_mixed"]["launches"]["csr_spmm"][BF16] == hops):
        raise AssertionError(f"rank {rank}: mixed ring against gather: "
                             f"{runs['ring_mixed']}")
    # memory='auto' with half the gather/remat plan's estimate: no plan
    # fits, and the autopilot's last candidate is the ring's (at P = 2
    # the model puts every ring plan above the gather's)
    budget = estimate_plan_bytes(ds.graph.num_nodes, ds.graph.num_edges,
                                 LAYERS, num_parts=2, remat=True) // 2
    tr, al, ms = counted("autopilot", F32, lambda: _ring_run(
        torch, ds, "cuda", "float32", params, 2, memory="auto",
        hbm_bytes=budget))
    runs["autopilot"].update(losses=al.tolist(), step_ms=ms,
                             budget_bytes=int(budget),
                             plan={"halo": tr.config.halo,
                                   "remat": tr.config.remat,
                                   "features": tr.config.features},
                             modeled_bytes=tr.modeled_bytes)
    if tr.config.halo != "ring":
        raise AssertionError(f"rank {rank}: memory='auto' under the gather "
                             f"plans picked {runs['autopilot']['plan']}")
    modeled["ring_remat"] = tr.modeled_bytes
    del tr
    torch.cuda.empty_cache()
    # a forced repartition (the first boundary moved by FORCED_SHIFT),
    # then the steps: the weights against the gather run's, which never
    # repartitions
    def force(t_r):
        (l0, r0), (l1, r1) = t_r.plan.bounds
        cut = r0 - int(FORCED_SHIFT * (r0 - l0 + 1))
        t_r._repartition([(l0, cut), (cut + 1, r1)])
    tr, rl, ms = counted("rebalance", F32, lambda: _ring_run(
        torch, ds, "cuda", "float32", params, 2, before=force))
    diffs = [(tr.params[k].detach() - gather_params[k]).abs()
             for k in gather_params]
    wt = REBALANCE_WEIGHT_TOL
    worst = max(float((t - wt["rtol"] * gather_params[k].abs()).max())
                for t, k in zip(diffs, gather_params))
    runs["rebalance"].update(
        losses=rl.tolist(), step_ms=ms, rebalances=tr._rebalances,
        bounds=[list(map(int, b)) for b in tr.plan.bounds],
        max_weight_diff=max(float(t.max()) for t in diffs),
        share_weights_within_1e_5=sum(int((t <= 1e-5).sum()) for t in diffs)
        / sum(int(t.numel()) for t in diffs),
        max_rel_loss_err=float(np.max(np.abs(rl - glosses)
                                      / np.abs(glosses))),
        max_excess_over_rtol=worst)
    if not (tr._rebalances == 1 and runs["rebalance"]["bounds"]
            != want_bounds and worst <= wt["atol"]
            and runs["rebalance"]["max_rel_loss_err"]
            <= PARITY_RTOL["float32"]):
        raise AssertionError(f"rank {rank}: forced rebalance: "
                             f"{runs['rebalance']}")
    del tr
    torch.cuda.empty_cache()
    out["runs"] = runs
    out["modeled_bytes"] = modeled
    # the layouts at the arxiv shape against 'cuda'
    ax = _map_dataset(arxiv_dir, ZOO_LAYERS[-1], name="arxiv_planted")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ax_params = {k: v.detach() for k, v in build_gcn(
        ZOO_LAYERS).init_params(gen, device="cuda").items()}
    lay = {}
    tr, base, ms = counted("arxiv_cuda", F32, lambda: _ring_run(
        torch, ax, "cuda", "float32", ax_params, 2, layers=ZOO_LAYERS))
    lay["cuda"] = {"losses": base.tolist(), "step_ms": ms}
    del tr
    for impl in RING_LAYOUTS:
        tr, ll, ms = _ring_run(torch, ax, impl, "float32", ax_params, 2,
                               layers=ZOO_LAYERS,
                               **(BD_TRAIN if impl == "bdense" else {}))
        rel = np.abs(ll - base) / np.abs(base)
        lay[impl] = {"losses": ll.tolist(), "step_ms": ms,
                     "max_rel_loss_err": float(rel.max()),
                     "route": tr.config.aggr_impl}
        if impl == "bdense":
            lay[impl]["occupancy"] = tr.data.bd_occupancy
            if tr.gctx.bd_a is None:
                raise AssertionError(f"rank {rank}: bdense at the arxiv "
                                     "shape has no dense tile")
        if rel.max() > PARITY_RTOL["float32"]:
            raise AssertionError(f"rank {rank}: {impl} at P = 2: {ll} "
                                 f"against 'cuda' {base}")
        del tr
        torch.cuda.empty_cache()
    out["layouts"] = lay
    return out


def _ring_p4(torch, ds, counts):
    """One rank's part of phase 16 at P = 4: the ring against the gather
    in fp32, 2 steps each with the peak reset before: the peak beside
    core/memory.py's modeled bytes."""
    from roc_tpu_torch.models.gcn import build_gcn
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    params = {k: v.detach() for k, v in build_gcn(LAYERS).init_params(
        gen, device="cuda").items()}
    out = {}
    for halo in ("ring", "gather"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counts.zero()
        tr, losses, ms = _ring_run(torch, ds, "cuda", "float32", params, 4,
                                   steps=2, halo=halo)
        out[halo] = {"peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "modeled_gb": tr.modeled_bytes / 1e9,
                     "losses": losses.tolist(), "step_ms": ms,
                     "launches": counts.read(F32),
                     "part_nodes": tr.plan.part_nodes}
        if halo == "ring":
            out[halo]["pair_edges"] = tr.data.pair_edges
            out[halo]["padding_ratio"] = tr.data.ring_padding_ratio
        del tr
    rel = np.abs(np.asarray(out["ring"]["losses"])
                 - out["gather"]["losses"]) / np.abs(out["gather"]["losses"])
    out["max_rel_loss_err"] = float(rel.max())
    if rel.max() > PARITY_RTOL["float32"]:
        raise AssertionError(f"P = 4 ring against gather: {out}")
    return out


def ring_rank_job(data_dir, arxiv_dir, num_classes, parts):
    """One rank of phase 16, in a process spawned by
    :func:`parallel.distributed.run_ranks` on card 0: map the Reddit-shape
    dataset and run :func:`_ring_p2` or :func:`_ring_p4`, every path with
    the counts zeroed just before and read just after.  Returns its
    record and its counts."""
    import torch
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    _build.library()
    counts = Launches(torch)
    ds = _map_dataset(data_dir, num_classes)
    t0 = time.perf_counter()
    rec = (_ring_p2(torch, ds, counts, arxiv_dir) if parts == 2
           else _ring_p4(torch, ds, counts))
    rec["rank"] = torch.distributed.get_rank()
    rec["seconds"] = time.perf_counter() - t0
    rec["rss_peak_gb"] = _rss_gb()
    return {"record": rec, "counted": counts.counted}


def arxiv_planted(seed=SEED):
    """The partitioned layouts' graph: ogbn-arxiv's shape (V, E, 128 in,
    40 out; features, labels and masks of ``synthetic_dataset``) with the
    edges of ``planted_community_csr`` (communities of PLANTED_ROWS rows,
    in their own order), symmetrised, with self edges."""
    from roc_tpu_torch.core.graph import (add_self_edges, from_edge_list,
                                          planted_community_csr,
                                          synthetic_dataset)
    ds = synthetic_dataset(ZOO_V, 2, in_dim=ZOO_LAYERS[0],
                           num_classes=ZOO_LAYERS[-1], seed=seed,
                           name="arxiv_planted")
    g0 = planted_community_csr(ZOO_V, ZOO_E, community_rows=PLANTED_ROWS,
                               seed=seed, shuffle=False)
    dst = np.repeat(np.arange(ZOO_V), np.diff(g0.row_ptr))
    return dataclasses.replace(ds, graph=add_self_edges(from_edge_list(
        g0.col_idx, dst, ZOO_V, symmetrize=True)))


def ring_child(data_dir, arxiv_dir, num_classes, out_path):
    """Phase 16 in a fresh process: two gloo ranks on card 0 over the
    Reddit-shape dataset the parent saved in ``data_dir`` (the GCN
    602-256-41 at full width, phase 5's weights, dropout 0), then four;
    writes the record and the ranks' counts to ``out_path``.

    At P = 2 each rank: the ring in fp32 (K3 at every hop, its row ranges
    covering no padding, held to its plain version at each hop's shape),
    the ring with the overlap off (the same bits), the gather through
    'auto' on the same split (the card's row, K4; the bounds the numpy
    cost split's; losses within PARITY_RTOL and logits within PREDICT_TOL
    of the ring's), 'mixed' ring against gather, memory='auto' under the
    gather plans (the ring), a forced repartition (the objectives within
    PARITY_RTOL of the gather run's, the weights within
    REBALANCE_WEIGHT_TOL), and at the arxiv shape
    (:func:`arxiv_planted`) 'sectioned', 'flat_sum' and 'bdense' 3 steps
    each against 'cuda'.  At P = 4 each rank's peak on the ring and on
    the gather beside the modeled bytes.  Two or four CUDA contexts share
    the card and gloo stages every transfer through the host: the times
    are a layout check, not a speed number."""
    from roc_tpu_torch.parallel.distributed import run_ranks
    t0 = time.perf_counter()
    ax = arxiv_planted()
    os.makedirs(arxiv_dir, exist_ok=True)
    _save_dataset(ax, arxiv_dir)
    data_s = time.perf_counter() - t0
    rec: Dict[str, Any] = {"arxiv": {"V": ax.graph.num_nodes,
                                     "E": ax.graph.num_edges,
                                     "build_s": data_s}}
    del ax
    counted = {key: {name: 0 for name in KERNELS} for key in (F32, BF16)}
    for parts in (2, 4):
        t1 = time.perf_counter()
        ranks = run_ranks(ring_rank_job, parts, backend="gloo",
                          timeout_s=900, data_dir=data_dir,
                          arxiv_dir=arxiv_dir, num_classes=num_classes,
                          parts=parts)
        for r in ranks:
            for key in (F32, BF16):
                for name in KERNELS:
                    counted[key][name] += r["counted"][key][name]
        recs = [r["record"] for r in ranks]
        rec[f"p{parts}"] = {"seconds": time.perf_counter() - t1,
                            "ranks": recs}
        log({"phase": f"dist_ring_p{parts}",
             "seconds": rec[f"p{parts}"]["seconds"],
             **({"ranks": [{k: v for k, v in r.items()
                            if k != "hop_checks"} for r in recs]}
                if parts == 2 else {"ranks": recs})})
        if parts == 2:
            log({"phase": "dist_ring_hops",
                 "rows": [dict(rank=r["rank"], **h) for r in recs
                          for h in r["hop_checks"]]})
    rec["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"record": rec, "counted": counted}, f)


def start_ring_child(tmp, num_classes):
    """:func:`ring_child` pre-started on the Reddit shape under
    ``tmp``/reddit."""
    data, arxiv = os.path.join(tmp, "reddit"), os.path.join(tmp, "arxiv")
    out = os.path.join(tmp, "ring.json")
    return _Child(f"ring_child({data!r}, {arxiv!r}, {num_classes}, "
                  f"{out!r})", 600, "phase 16 (dist_ring)")


def run_ring_child(tmp, num_classes, pre=None):
    """:func:`ring_child` in a fresh Python process on the Reddit-shape
    dataset saved under ``tmp``/reddit; returns what it wrote."""
    (pre or start_ring_child(tmp, num_classes)).run()
    with open(os.path.join(tmp, "ring.json")) as f:
        return json.load(f)


# ------------------------------------------------------- 17. dist_mesh

MESH_STEPS = 3
# the 1-D P = 2 runs of phase 16 that phase 17 holds its runs to, by
# (halo, dtype mode)
MESH_REFS = {("gather", "float32"): "gather_auto_fp32",
             ("ring", "float32"): "ring_fp32",
             ("gather", "mixed"): "gather_mixed",
             ("ring", "mixed"): "ring_mixed"}


def _rss_gb():
    """This process's peak resident host memory, GB (Linux: KB).  Linux
    keeps ru_maxrss across exec, so in a spawned rank it is the larger
    of the rank's own peak and the resident size of the process it was
    forked from: a reading above the one taken at the rank's start is
    the rank's own."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def _rss_now_gb():
    """This process's resident host memory now, GB (``/proc/self/statm``),
    or None where the system has no such file."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
    except (OSError, ValueError, IndexError):
        return None
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e9


class _ReadBytes:
    """Every core/graph.py ``_read_slice`` call of a block, as ``(section,
    byte offset, bytes)``: the .lux row offsets ("lux_rows") and columns
    ("lux_cols"), the .feats.bin rows ("feats"), any other file
    ("other")."""

    def __init__(self, num_nodes, in_dim):
        from roc_tpu_torch.core import graph
        self.graph, self.col_base = graph, 12 + 8 * num_nodes
        self.in_dim, self.reads = in_dim, []

    def __enter__(self):
        real = self.real = self.graph._read_slice

        def spy(f, offset, count, dtype):
            key = ("feats" if f.name.endswith(".feats.bin") else
                   "other" if not f.name.endswith(".lux") else
                   "lux_cols" if offset >= self.col_base else "lux_rows")
            self.reads.append((key, int(offset),
                               int(count) * np.dtype(dtype).itemsize))
            return real(f, offset, count, dtype)
        self.graph._read_slice = spy
        return self

    def __exit__(self, *exc):
        self.graph._read_slice = self.real

    @property
    def bytes(self):
        out = {"lux_rows": 0, "lux_cols": 0, "feats": 0, "other": 0}
        for key, _, n in self.reads:
            out[key] += n
        return out

    def part(self, plan, p):
        """Part ``p``'s column bytes and feature rows' bytes, and the
        column and feature bytes read outside them."""
        (l, r), (e0, e1) = plan.bounds[p], plan.edge_range(p)
        ranges = {"lux_cols": (self.col_base + 4 * e0,
                               self.col_base + 4 * e1),
                  "feats": (4 * self.in_dim * l, 4 * self.in_dim * (r + 1))}
        outside = 0
        for key, off, n in self.reads:
            if key in ranges:
                lo, hi = ranges[key]
                outside += n - max(0, min(off + n, hi) - max(off, lo))
        return {"lux_cols": (e1 - e0) * 4,
                "feats": (r - l + 1) * self.in_dim * 4, "outside": outside}

    def local(self, plan, p):
        """Whether the block read part ``p``'s columns and feature rows
        once each and no column or feature byte outside them."""
        want, got = self.part(plan, p), self.bytes
        return (want["outside"] == 0 and got["lux_cols"] == want["lux_cols"]
                and got["feats"] == want["feats"])


def _table_digest(d):
    """sha256 of a ShardedData's device tables and host fields, by field
    name (the tuples field by field)."""
    import hashlib
    import torch
    h = hashlib.sha256()
    for f in sorted(x.name for x in dataclasses.fields(d)):
        v = getattr(d, f)
        vs = v if isinstance(v, tuple) else (v,)
        for t in vs:
            if isinstance(t, torch.Tensor):
                h.update(f.encode())
                h.update(t.detach().cpu().contiguous().view(-1).view(
                    torch.uint8).numpy().tobytes())
            elif isinstance(t, np.ndarray):
                h.update(f.encode())
                h.update(np.ascontiguousarray(t).tobytes())
            elif t is not None and not isinstance(t, dict):
                h.update(f"{f}={t!r}".encode())
    return h.hexdigest()


def _mesh_trainer(torch, dataset, mode, halo, params, parts, mesh="auto",
                  group=None, **kw):
    """phase 16's DistributedTrainer (the GCN 602-256-41 at dropout 0 from
    ``params``, the cost split) on card 0, over ``dataset`` (a Dataset or
    a DataSource), on ``mesh``."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.parallel.distributed import DistributedTrainer
    from roc_tpu_torch.train.trainer import TrainConfig, resolve_dtypes
    dtype, compute_dtype = resolve_dtypes(mode)
    return DistributedTrainer(
        build_gcn(LAYERS, dropout_rate=0.0), dataset, parts, TrainConfig(
            aggr_impl="cuda", symmetric=True, seed=SEED, dtype=dtype,
            compute_dtype=compute_dtype, eval_every=10 ** 6, verbose=False,
            halo=halo, mesh=mesh, **TRAIN), params=params,
        device=torch.device("cuda", 0), group=group, **kw)


def _mesh_steps(torch, tr, n):
    """``n`` steps, each synchronised: the objectives so far and the
    steady steps' mean wall ms."""
    ms = []
    for _ in range(n):
        t = time.perf_counter()
        tr.train(1)
        tr.sync()
        ms.append((time.perf_counter() - t) * 1e3)
    losses = torch.stack(tr.losses).double().cpu().numpy()
    if not np.isfinite(losses).all():
        raise AssertionError(f"mesh run: losses {losses}")
    return losses, float(np.mean(ms[1:])) if n > 1 else ms[0]


def _gcn_params(torch):
    """Phase 5's weights (the GCN's init from SEED on the card)."""
    from roc_tpu_torch.models.gcn import build_gcn
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    return {k: v.detach() for k, v in build_gcn(LAYERS).init_params(
        gen, device="cuda").items()}


def _rank_setup(torch):
    """A spawned rank's set-up on card 0: the device, the fp32 matmul
    precision, the kernels' library, a CUDA context, and the launch
    counts; the GPU peak reset.  Returns the counts and the host
    readings: ``rss_start_gb`` (ru_maxrss before the set-up, what the
    rank inherited), ``rss_setup_gb`` (resident after it, the process's
    baseline before any data)."""
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    start = _rss_gb()
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    _build.library()
    torch.empty(1, device="cuda").sum().item()
    counts = Launches(torch)
    torch.cuda.reset_peak_memory_stats()
    return counts, {"rss_start_gb": start, "rss_setup_gb": _rss_now_gb()}


def mesh_p2_job(prefix, data_dir, num_classes, ref_losses):
    """One rank of phase 17's P = 2 run, spawned on card 0: this rank's
    tables from a FileSource over the reference-layout files
    (shard_dataset_local under the cost split the trainer would take),
    3 counted steps through DistributedTrainer(data=, plan=) bit-equal to
    phase 16's gather losses, with every byte read from the files through
    all of it (the part's columns and feature rows once each, nothing of
    them outside the part), the host peak RSS after the set-up and after
    the steps, and the GPU peak; then (after those readings) the whole
    Dataset mapped and shard_dataset's tables from it, whose digest must
    equal the FileSource build's."""
    import torch
    from roc_tpu_torch.core.costmodel import PartitionCostModel
    from roc_tpu_torch.core.partition import partition_plan
    from roc_tpu_torch.core.source import FileSource
    from roc_tpu_torch.parallel.distributed import Collectives, shard_dataset
    from roc_tpu_torch.parallel.multihost import shard_dataset_local
    from roc_tpu_torch.train.trainer import TrainConfig
    counts, rss_setup = _rank_setup(torch)
    rank = torch.distributed.get_rank()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    chunk = TrainConfig().chunk
    params = _gcn_params(torch)
    src = FileSource(prefix, LAYERS[0], num_classes)
    with _ReadBytes(src.num_nodes, LAYERS[0]) as rb:
        plan = partition_plan(
            src.row_ptr(), 2, node_multiple=8, edge_multiple=chunk,
            method="cost", cost_weights=PartitionCostModel(
                node_multiple=8, edge_multiple=chunk).search_weights(
                    attn_edges=False, flat8=False))
        data = shard_dataset_local(src, plan, rank, device=dev,
                                   aggr_impl="cuda", fuse=True)
        build_s = time.perf_counter() - t0
        digest = _table_digest(data)
        counts.zero()
        tr = _mesh_trainer(torch, src, "float32", "gather", params, 2,
                           data=data, plan=plan)
        losses, ms = _mesh_steps(torch, tr, MESH_STEPS)
    launches = counts.read(F32)
    out = {"rank": rank, "bounds": [list(map(int, b)) for b in plan.bounds],
           "build_s": build_s, "read_bytes": rb.bytes,
           "part_bytes": rb.part(plan, rank), "reads_local":
           rb.local(plan, rank),
           "file_bytes": {"lux_cols": src.num_edges * 4,
                          "feats": src.num_nodes * LAYERS[0] * 4},
           "losses": losses.tolist(), "step_ms": ms, "launches": launches,
           **rss_setup, "rss_peak_gb": _rss_gb(),
           "rss_end_gb": _rss_now_gb(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses_equal_phase16": bool(np.array_equal(
               losses, np.asarray(ref_losses)))}
    del tr, data
    torch.cuda.empty_cache()
    ds = _map_dataset(data_dir, num_classes)
    want = shard_dataset(ds, plan, rank, dev, aggr_impl="cuda", fuse=True,
                         agree_max=Collectives().agree_max)
    out["digest"] = digest
    out["digest_equal"] = digest == _table_digest(want)
    if not (out["digest_equal"] and out["losses_equal_phase16"]
            and out["reads_local"]
            and all(launches[k][F32] for k in (
                "indegree_norm", "scale_act", "ell_aggregate"))
            and launches["indegree_norm_masked"]):
        raise AssertionError(f"rank {rank}: P = 2 from the files: {out}, "
                             f"phase 16's losses {ref_losses}")
    return {"record": out, "counted": counts.counted}


def mesh_2x2_job(prefix, num_classes, refs, ckdir):
    """One rank of phase 17's 2x2 mesh, spawned on card 0 (4 ranks), each
    trainer building its part from the FileSource: the gather on 'cuda'
    then the ring, in fp32 and 'mixed', 3 counted steps each against
    phase 16's 1-D P = 2 objectives, the params and Adam moments' at-rest
    shapes, the peak GPU memory, and every byte each trainer read from
    the files through its construction and steps (the part's columns and
    feature rows once each, nothing of them outside the part); the fp32
    gather run saves a checkpoint after 2 steps (two writers), which
    restores into a fresh 2x2 trainer (its next step the uninterrupted
    run's 3rd, bit for bit) and into 1-D P = 2 trainers (the saved
    weights); the host peak RSS after the set-up and at the end."""
    import torch
    from roc_tpu_torch.core.source import FileSource
    from roc_tpu_torch.parallel import model_shard_spec
    from roc_tpu_torch.utils.checkpoint import (checkpoint_trainer,
                                                restore_trainer)
    counts, rss_setup = _rank_setup(torch)
    rank = torch.distributed.get_rank()
    src = FileSource(prefix, LAYERS[0], num_classes)
    params = _gcn_params(torch)
    out: Dict[str, Any] = {"rank": rank, "runs": {}, **rss_setup}
    kept = {}
    for halo, mode in (("gather", "float32"), ("gather", "mixed"),
                       ("ring", "float32"), ("ring", "mixed")):
        key = F32 if mode == "float32" else BF16
        tag = f"{halo}_{mode}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        counts.zero()
        rec: Dict[str, Any] = {}
        with _ReadBytes(src.num_nodes, LAYERS[0]) as rb:
            tr = _mesh_trainer(torch, src, mode, halo, params, 2,
                               mesh="2x2")
            if tag == "gather_float32":
                _mesh_steps(torch, tr, MESH_STEPS - 1)
                rec["save"] = checkpoint_trainer(tr, ckdir)
                kept["saved"] = {k: v.detach().clone()
                                 for k, v in tr._full_params().items()}
            losses, ms = _mesh_steps(torch, tr, MESH_STEPS -
                                     len(tr.losses))
        losses = torch.stack(tr.losses).double().cpu().numpy()
        ref = np.asarray(refs[tag])
        rel = np.abs(losses - ref) / np.abs(ref)
        full = tr._full_params()
        shapes_ok = all(
            tuple(tr.params[k].shape) == tuple(tr.opt_state.m[k].shape)
            == tuple(tr.opt_state.v[k].shape) == tuple(
                n // 2 if spec is not None and spec[i] == "model" else n
                for i, n in enumerate(full[k].shape))
            for k in full
            for spec in (model_shard_spec(tuple(full[k].shape), 2),))
        rec.update(losses=losses.tolist(), step_ms=ms,
                   max_rel_vs_1d=float(rel.max()),
                   bit_equal_1d=bool(np.array_equal(losses, ref)),
                   rest_shapes={k: list(v.shape)
                                for k, v in tr.params.items()},
                   shapes_ok=shapes_ok,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   read_bytes=rb.bytes, part_bytes=rb.part(tr.plan, tr.rank),
                   reads_local=rb.local(tr.plan, tr.rank),
                   launches=counts.read(key))
        n = rec["launches"]
        kernel = "csr_spmm" if halo == "ring" else "ell_aggregate"
        if not (rel.max() <= PARITY_RTOL[mode] and shapes_ok
                and rec["reads_local"]
                and n["indegree_norm"][key] and n["scale_act"][key]
                and n[kernel][key] and n["indegree_norm_masked"]):
            raise AssertionError(f"rank {rank}: 2x2 {tag}: {rec}, 1-D "
                                 f"{ref.tolist()}")
        if tag == "gather_float32":
            kept["final"] = {k: v.detach().clone() for k, v in full.items()}
            kept["losses"] = losses
            # the rank's live replication ledger beside the modeled one
            # of the same (parts, model) shape (analysis/sharding_lint.py)
            from roc_tpu_torch.analysis.sharding_lint import rank_ledgers
            live, modeled = rank_ledgers(tr)
            out["ledger"] = {
                k: [{f: e[f] for f in ("role", "shape", "dtype", "split",
                                       "bytes", "per_device_bytes")}
                    for e in rows] for k, rows in (("live", live),
                                                   ("modeled", modeled))}
        out["runs"][tag] = rec
        del tr, full
    # the two-writer checkpoint, restored into a fresh 2x2 trainer (one
    # step) and into 1-D trainers of two parts on two subgroups
    torch.cuda.empty_cache()
    with _ReadBytes(src.num_nodes, LAYERS[0]) as rb:
        tr = _mesh_trainer(torch, src, "float32", "gather", None, 2,
                           mesh="2x2")
        restore_trainer(tr, ckdir)
        _mesh_steps(torch, tr, 1)
    local = rb.local(tr.plan, tr.rank)
    step = float(tr.losses[-1])
    same = step == float(kept["losses"][-1]) and all(
        torch.equal(v, kept["final"][k])
        for k, v in tr._full_params().items())
    del tr
    groups = [torch.distributed.new_group([0, 1]),
              torch.distributed.new_group([2, 3])]
    with _ReadBytes(src.num_nodes, LAYERS[0]) as rb:
        tr = _mesh_trainer(torch, src, "float32", "gather", None, 2,
                           group=groups[rank // 2])
        restore_trainer(tr, ckdir)
    local = local and rb.local(tr.plan, tr.rank)
    same_1d = all(torch.equal(tr.params[k], kept["saved"][k])
                  for k in kept["saved"])
    del tr
    out["restore"] = {"resumed_step_equal": same, "restored_1d_equal":
                      same_1d, "resumed_loss": step, "reads_local": local}
    if not (same and same_1d and local):
        raise AssertionError(f"rank {rank}: 2x2 restore: {out['restore']}")
    out["rss_peak_gb"] = _rss_gb()
    out["rss_end_gb"] = _rss_now_gb()
    return {"record": out, "counted": counts.counted}


def mesh_child(data_dir, tmp, num_classes, refs, out_path):
    """Phase 17 in a fresh process: the Reddit-shape dataset saved
    in ``data_dir``, written in the reference layout with the port's
    save_dataset (.add_self_edge.lux, .feats.bin, .label, .mask) under
    ``tmp``; the native loader's calls and load_lux_rows of one part
    against the numpy arrays; then two gloo ranks from the FileSource
    (:func:`mesh_p2_job`) and four on the 2x2 mesh (:func:`mesh_2x2_job`),
    ``refs`` phase 16's 1-D objectives (or a JSON file of them).  Writes the record and the ranks'
    counts to ``out_path``.  Ranks sharing one card over gloo: a layout
    check, not a speed number."""
    from roc_tpu_torch import native
    from roc_tpu_torch.core.graph import load_lux, load_lux_rows, save_dataset
    from roc_tpu_torch.parallel.distributed import run_ranks
    if isinstance(refs, str):
        with open(refs) as f:
            refs = json.load(f)
    t0 = time.perf_counter()
    ds = _map_dataset(data_dir, num_classes)
    prefix = os.path.join(tmp, "reddit")
    before = dict(native.calls)
    save_dataset(ds, prefix, csv=False)
    write_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    g = load_lux(prefix + ".add_self_edge.lux")
    whole_equal = bool(np.array_equal(g.row_ptr, ds.graph.row_ptr)
                       and np.array_equal(g.col_idx, ds.graph.col_idx))
    del g
    read_s = time.perf_counter() - t1
    lo, hi = ds.graph.num_nodes // 3, 2 * ds.graph.num_nodes // 3
    ptr, col = load_lux_rows(prefix + ".add_self_edge.lux", lo, hi)
    rp = np.asarray(ds.graph.row_ptr)
    rows_equal = bool(np.array_equal(ptr, rp[lo:hi + 1] - rp[lo]) and
                      np.array_equal(col, ds.graph.col_idx[rp[lo]:rp[hi]]))
    calls = {k: native.calls.get(k, 0) - before.get(k, 0)
             for k in ("save_lux", "lux_header", "load_lux")}
    rec: Dict[str, Any] = {"files": {
        "write_s": write_s, "native_read_s": read_s, "calls": calls,
        "native_whole_equal": whole_equal, "rows_equal": rows_equal,
        "bytes": {ext: os.path.getsize(prefix + ext) for ext in (
            ".add_self_edge.lux", ".feats.bin", ".label", ".mask")}}}
    log({"phase": "dist_mesh_files", **rec["files"]})
    if not (whole_equal and rows_equal and calls["save_lux"]
            and calls["load_lux"]):
        raise AssertionError(f"phase 17 files: {rec['files']}")
    del ds
    counted = {key: {name: 0 for name in KERNELS} for key in (F32, BF16)}

    def add(ranks):
        for r in ranks:
            for key in (F32, BF16):
                for name in KERNELS:
                    counted[key][name] += r["counted"][key][name]
        return [r["record"] for r in ranks]

    t1 = time.perf_counter()
    rec["p2"] = add(run_ranks(mesh_p2_job, 2, backend="gloo",
                              timeout_s=600, prefix=prefix,
                              data_dir=data_dir, num_classes=num_classes,
                              ref_losses=refs["gather_float32"]))
    rec["p2_s"] = time.perf_counter() - t1
    log({"phase": "dist_mesh_p2", "seconds": rec["p2_s"], "ranks": rec["p2"]})
    t1 = time.perf_counter()
    ckdir = os.path.join(tmp, "ck_2x2")
    rec["m2x2"] = add(run_ranks(mesh_2x2_job, 4, backend="gloo",
                                timeout_s=900, prefix=prefix,
                                num_classes=num_classes, refs=refs,
                                ckdir=ckdir))
    rec["m2x2_s"] = time.perf_counter() - t1
    from roc_tpu_torch.utils.checkpoint import read_manifest
    rec["manifest_shards"] = [s["file"] for s in
                              read_manifest(ckdir)["shards"]]
    if len(rec["manifest_shards"]) != 2:
        raise AssertionError(f"2x2 manifest: {rec['manifest_shards']}")
    log({"phase": "dist_mesh_2x2", "seconds": rec["m2x2_s"],
         "manifest_shards": rec["manifest_shards"],
         "ranks": [{k: v for k, v in r.items() if k != "ledger"}
                   for r in rec["m2x2"]]})
    for r in rec["m2x2"]:
        log({"phase": "dist_mesh_ledger", "rank": r["rank"],
             "live": r["ledger"]["live"], "modeled": r["ledger"]["modeled"]})
    rec["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"record": rec, "counted": counted}, f)


def start_mesh_child(tmp, num_classes, refs):
    """:func:`mesh_child` pre-started on the Reddit shape under
    ``tmp``/reddit; ``refs`` phase 16's objectives or the path of a JSON
    file that holds them by the time the child runs."""
    data, files = os.path.join(tmp, "reddit"), os.path.join(tmp, "files")
    os.makedirs(files, exist_ok=True)
    out = os.path.join(tmp, "mesh.json")
    return _Child(f"mesh_child({data!r}, {files!r}, {num_classes}, "
                  f"{refs!r}, {out!r})", 900, "phase 17 (dist_mesh)")


def run_mesh_child(tmp, num_classes, refs, pre=None):
    """:func:`mesh_child` in a fresh Python process on the Reddit-shape
    dataset saved under ``tmp``/reddit; returns what it wrote."""
    (pre or start_mesh_child(tmp, num_classes, refs)).run()
    with open(os.path.join(tmp, "mesh.json")) as f:
        return json.load(f)


def ring_ab(other, out_path=None):
    """Phase 16 of another checkout ``other`` (its root, e.g. the parent
    commit unpacked with ``git archive``) and of this one on one card, in
    turns other, this, this, other, on one Reddit-shape dataset; then
    this checkout's phase 17 held to the second run of this one.  Prints
    each run's step ms (``ab`` lines) and phase 17's readings, and writes
    them to ``out_path`` as JSON.  ``python -c "import chip_smoke as s;
    s.ring_ab('<other checkout>', 'ab.json')"`` on the card."""
    from roc_tpu_torch.core.graph import synthetic_dataset
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"other": os.path.abspath(other), "this": here}

    def ring(tree, tmp, tag):
        out = os.path.join(tmp, f"ring_{tag}.json")
        code = (f"import json, chip_smoke as s; json.dump("
                f"s.run_ring_child({tmp!r}, {LAYERS[-1]}), open({out!r}, "
                f"'w'))")
        t = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], cwd=trees[tree],
                       env=dict(os.environ, PYTHONPATH=trees[tree]),
                       check=True, timeout=900)
        wall = time.perf_counter() - t
        with open(out) as f:
            rec = json.load(f)["record"]
        ranks = rec["p2"]["ranks"]
        summary = {"tag": tag, "tree": tree, "wall_s": wall,
                   "step_ms": [{k: v["step_ms"] for k, v in r["runs"].items()
                                if "step_ms" in v} for r in ranks],
                   "ring_table_bytes": [r["ring"].get("table_bytes")
                                        for r in ranks],
                   "losses": {k: v["losses"]
                              for k, v in ranks[0]["runs"].items()
                              if "losses" in v}}
        log({"phase": "ab", **summary})
        return rec, summary

    print(card_line(), flush=True)
    t0 = time.perf_counter()
    ds = synthetic_dataset(num_nodes=V, avg_degree=AVG_DEGREE,
                           in_dim=LAYERS[0], num_classes=LAYERS[-1],
                           seed=SEED, name="reddit_shape")
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "reddit"))
        _save_dataset(ds, os.path.join(tmp, "reddit"))
        del ds
        log({"phase": "ab_data", "seconds": time.perf_counter() - t0})
        res = []
        for i, tree in enumerate(("other", "this", "this", "other")):
            rec, summary = ring(tree, tmp, f"{tree}{i}")
            res.append(summary)
            if i == 2:
                runs16 = rec["p2"]["ranks"][0]["runs"]
                refs = {f"{h}_{m}": runs16[name]["losses"]
                        for (h, m), name in MESH_REFS.items()}
        t = time.perf_counter()
        m = run_mesh_child(tmp, LAYERS[-1], refs)["record"]
    keep = ("read_bytes", "part_bytes", "reads_local", "peak_gb", "step_ms")
    rss = ("rss_start_gb", "rss_setup_gb", "rss_peak_gb", "rss_end_gb")
    p17 = {"seconds": time.perf_counter() - t,
           "p2": [dict({k: r[k] for k in keep + rss}) for r in m["p2"]],
           "m2x2": [{**{k: r[k] for k in rss}, "restore": r["restore"],
                     "runs": {k: dict({x: v[x] for x in keep},
                                      **({"save": v["save"]}
                                         if "save" in v else {}))
                              for k, v in r["runs"].items()}}
                    for r in m["m2x2"]],
           "manifest_shards": m["manifest_shards"]}
    log({"phase": "ab_p17", **p17})
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"ab": res, "p17": p17}, f)
    print(card_line(), flush=True)


# ---------------------------------------------------------------------------
# 18. The replica fleet (serve/router.py, serve/replica.py): tables
# exported with --shards, replicas on this card behind routers, the
# cross-shard gather, the capacity refusal, the sharded refresh and the
# serve drills
# ---------------------------------------------------------------------------

FLEET_SHARDS = 2
# a replica's table budget as a share of the full table: a slice (half
# the rows and the halo) fits, the whole table does not
FLEET_BUDGET = 0.6
# a merged trace's lanes on one host: each lane's clock offset within this
# of the router lane's (the stamps' wall clock has ms resolution)
FLEET_SKEW_MS = 5.0
# the akx head's GEMM runs at the bucket of the sub-request a replica
# receives, and a GEMM is bit-exact within one bucket size only
FLEET_TOL = 1e-5
FLEET_ARGS = ["--drain-timeout", "3"]
FLEET_SEAM = 256
REFRESH_PAIRS = 8
# the JAX package's drill strings (tests/test_serve_robustness.py)
FLEET_DRILLS = ("replica_sigkill:2:1", "replica_stall:2:0", "serve_io:1:0",
                "table_swap_mid_query:1:0")
FLEET_SLOS = ("availability(ok/requests) >= 0.99 over 60s",
              "p99(request_ms) <= 50ms over 60s")
# a hedge threshold no request reaches: the drills that must see one
# replica's own answers turn hedging off
NO_HEDGE_MS = 600_000.0


def _fleet_env(fault=None):
    env = dict(os.environ)
    env.pop("ROC_TPU_FAULT", None)
    if fault:
        env["ROC_TPU_FAULT"] = fault
    return env


def _shard_summary(man, export_s):
    sb = man["shards"]
    return {"plan": sb["plan"], "rows_padded": sb["rows_padded"],
            "halo": sb["halo"], "bytes_per_replica": sb["bytes_per_replica"],
            "bytes_full": sb["bytes_full"],
            "slice_share": sb["bytes_per_replica"] / sb["bytes_full"],
            "export_s": export_s}


def fleet_exports(torch, ds, akx_params, gcn_params, counts, root):
    """The fleet's three artifacts, each with FLEET_SHARDS slices: the SGC
    602-41 on 'akx' in fp32 (its precompute, the walk on K3, with the
    counts zeroed just before and read just after) and int8 (the same
    table), and the GCN 602-256-41 on 'table' (its forward on K1, K4 and
    K2, counted the same way).  Returns the record and, per artifact, the
    exporting predictor and its path."""
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.models.sgc import build_sgc
    from roc_tpu_torch.serve.export import build_predictor, export_predictor
    from roc_tpu_torch.train.trainer import TrainConfig
    cfg = TrainConfig(aggr_impl="cuda", symmetric=True, seed=SEED)
    sgc = build_sgc(AKX_LAYERS, k=AKX_HOPS)
    rec, out = {}, {}
    counts.zero()
    akx, wall = _timed(torch, lambda: build_predictor(sgc, ds, cfg,
                                                      params=akx_params))
    launches = counts.read(F32)
    if not launches["csr_spmm"][F32] or any(launches[k][F32]
                                            for k in _CHAIN):
        raise AssertionError(f"fleet: the akx walk did not run K3 alone: "
                             f"{launches}")
    rec["akx_precompute"] = {"wall_s": wall, "launches": launches}
    akx8 = build_predictor(sgc, ds, cfg, params=akx_params, cache=akx.cache,
                           quant="int8")
    counts.zero()
    tab, wall = _timed(torch, lambda: build_predictor(
        build_gcn(LAYERS), ds, cfg, params=gcn_params,
        backend="precomputed"))
    launches = counts.read(F32)
    if tab.flavor != "table" or not all(launches[k][F32] for k in _CHAIN):
        raise AssertionError(f"fleet: the GCN forward did not run K1, K4 "
                             f"and K2: {launches}")
    rec["table_precompute"] = {"wall_s": wall, "launches": launches}
    for name, pred in (("akx_fp32", akx), ("akx_int8", akx8),
                       ("table", tab)):
        path = os.path.join(root, name)
        man, s = _timed(torch, lambda: export_predictor(
            pred, path, shards=FLEET_SHARDS))
        rec[name] = _shard_summary(man, s)
        out[name] = (pred, path, man)
    return rec, out


def _bit_share(got, want):
    return float(np.all(got == want, axis=1).mean()) if got.size else 1.0


def fleet_answers(name, pred, router, seam, rids=None):
    """A SAMPLE-id sample and a batch straddling the seam through the
    router against the exporting predictor's rows: bit-equal on 'table'
    (a gather), within FLEET_TOL of the logit scale on 'akx'.  ``rids``
    (a dict) receives each request's id by its label."""
    rtol = 0.0 if pred.flavor == "table" else FLEET_TOL
    out = []
    for label, ids in (("sample", _sample(pred.num_nodes, SEED + 61)),
                       ("seam", np.arange(seam - FLEET_SEAM,
                                          seam + FLEET_SEAM))):
        fut = router.submit(ids)
        if rids is not None:
            rids[label] = fut.rid
        got = np.asarray(fut.result(timeout=300))
        want = pred.query(ids)
        rec = _rows_check(f"{name}_{label}", got, want, rtol)
        rec["bit_equal_share"] = _bit_share(got, want)
        out.append(rec)
    return out


def fleet_latency(pred, router, seed, rids=None):
    """Each request size REPEATS times through the router and through the
    in-process Server on the unsharded table: medians, the router's
    stats, its wire_ms and gather_ms p50.  ``rids`` (a list) receives
    each router request's ``(rows, rid)``."""
    from roc_tpu_torch.serve.server import Server

    def med(rows):
        return {r["rows"]: r["median_ms"] for r in rows}

    def call(ids):
        fut = router.submit(ids)
        if rids is not None:
            rids.append((len(ids), fut.rid))
        return fut.result(timeout=300)
    rt = request_times(call, pred.num_nodes, seed)
    with Server(pred, max_wait_ms=0.2, name="chip_smoke_fleet") as srv:
        st = request_times(lambda i: srv.submit(i).result(timeout=300),
                           pred.num_nodes, seed)
        server_stats = srv.stats()
    wire = router.reg.histogram("wire_ms").quantile(0.5)
    stats = router.stats()
    return {"router_median_ms": med(rt), "server_median_ms": med(st),
            "router_p90_ms": {r["rows"]: r["p90_ms"] for r in rt},
            "wire_p50_ms": wire, "gather_p50_ms": stats["gather_p50_ms"],
            "router_stats": {k: v for k, v in stats.items()
                             if k != "replicas"},
            "replicas": stats["replicas"], "server_stats": server_stats}


def fleet_first(router, num_nodes, buckets):
    """The wall of each bucket's first request through ``router`` (ids of
    the bucket's size, id 0 first), in ms by size: what a client of a
    fresh fleet waits."""
    rng = np.random.RandomState(SEED + 70)
    out = {}
    for n in buckets:
        ids = rng.randint(0, num_nodes, size=n)
        ids[0] = 0
        t0 = time.perf_counter()
        router.submit(ids).result(timeout=300)
        out[int(n)] = (time.perf_counter() - t0) * 1e3
    return out


def fleet_capacity(art, budget):
    """The unsharded akx artifact under the slices' budget: the replica
    loads the whole table and exits 3 before ``ready``, stdout empty."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "roc_tpu_torch.serve.replica",
                        art, "--table-budget-bytes", str(budget)],
                       stdin=subprocess.DEVNULL, capture_output=True,
                       text=True, timeout=300, cwd=here,
                       env=dict(_fleet_env(), PYTHONPATH=here))
    rec = {"rc": r.returncode, "stdout": r.stdout[:200],
           "stderr_tail": r.stderr.strip().splitlines()[-1:],
           "budget": budget, "seconds": time.perf_counter() - t0}
    if r.returncode != 3 or r.stdout:
        raise AssertionError(f"fleet capacity: {rec}")
    return rec


def _wire_pair(a, b):
    from roc_tpu_torch.serve.errors import GatherError

    def mk(owner, me):
        def gather(ids, version):
            try:
                return owner.read_rows(ids, version)
            except GatherError:
                return None, None, -1, me.quant
        return gather
    a.gather_fn = mk(b, a)
    b.gather_fn = mk(a, b)


def fleet_refresh(torch, pred, art, man):
    """The sharded refresh in this process at the arxiv shape (at
    Reddit's degree the 2-hop set of a few edges is most of the graph,
    phase 13): the two shards loaded with ``load_predictor(shard=k)`` and
    wired gather_fn -> read_rows; REFRESH_PAIRS undirected edges across
    the seam appended through the full cache, the changed rows passed to
    both shards' apply_refresh.  Gates: each row applied by its owner,
    the versions in lockstep, the shards' host and device rows equal to
    the mutated table's, the answers (seam included) within FLEET_TOL of
    the full predictor's at the new version."""
    from roc_tpu_torch.serve.export import load_predictor
    shards = [load_predictor(art, shard=k) for k in range(FLEET_SHARDS)]
    _wire_pair(*shards)
    seam = man["shards"]["plan"][0][1]
    rng = np.random.RandomState(SEED + 62)
    u = seam - 1 - rng.randint(0, 64, size=REFRESH_PAIRS)
    v = seam + rng.randint(0, 64, size=REFRESH_PAIRS)
    src, dst = np.concatenate([u, v]), np.concatenate([v, u])
    ids = np.union1d(np.union1d(_sample(pred.num_nodes, SEED + 63), src),
                     np.arange(seam - FLEET_SEAM, seam + FLEET_SEAM))
    t0 = time.perf_counter()
    rows = pred.cache.add_edges(src, dst)
    host_ms = (time.perf_counter() - t0) * 1e3
    pred.refresh_rows(rows)
    values = np.asarray(pred.cache.table[rows], dtype=np.float32)
    t0 = time.perf_counter()
    applied = [s.apply_refresh(rows, values) for s in shards]
    apply_ms = (time.perf_counter() - t0) * 1e3
    want_v = pred.published().version
    rec = {"edges_appended": int(src.size), "rows_recomputed": int(rows.size),
           "applied": applied, "host_ms": host_ms, "apply_ms": apply_ms,
           "versions": [s.published().version for s in shards] + [want_v]}
    if (min(applied) <= 0 or sum(applied) != rows.size
            or any(s.published().version != want_v for s in shards)):
        raise AssertionError(f"fleet refresh: {rec}")
    full = pred.published().table
    for s in shards:
        lo, hi = s.shard
        own = np.arange(lo, hi)
        vals, _, _, _ = s.read_rows(own, want_v)
        dev = s.published().table[:hi - lo]
        if not (np.array_equal(vals, pred.cache.table[lo:hi])
                and torch.equal(dev, full[lo:hi])):
            raise AssertionError(f"fleet refresh: shard {s.shard}'s rows "
                                 f"differ from the mutated table's")
    want = pred.query(ids)
    rec["checks"] = []
    for s in shards:
        got = s.query(ids)
        c = _rows_check(f"refresh_shard{s.shard[0]}", got, want, FLEET_TOL)
        c.update(bit_equal_share=_bit_share(got, want),
                 gather_ms=s.last_gather_ms)
        rec["checks"].append(c)
    return rec


def _drill_sigkill(art, ref, scale, events, ev_path=None):
    """``ev_path``: the fleet's replicas append their events there (the
    merged trace of :func:`fleet_traces`)."""
    from roc_tpu_torch.serve.errors import ServeTimeout
    from roc_tpu_torch.serve.router import Router
    env = _fleet_env(FLEET_DRILLS[0])
    if ev_path:
        env["ROC_TPU_EVENTS"] = ev_path
    # no hedge: a hedge answering first would leave the dying replica no
    # request in flight to fail over
    with Router(art, n_replicas=2, env=env,
                default_deadline_ms=20_000.0, hedge_min_ms=NO_HEDGE_MS,
                replica_args=FLEET_ARGS) as router:
        t_warm = time.monotonic() + 120.0
        answered = set()        # the rids answered
        while time.monotonic() < t_warm:
            for p in [router.submit([0, 1]) for _ in range(2)]:
                p.result(timeout=60)
                answered.add(p.rid)
            reps = router.stats()["replicas"]
            if (any(not x["alive"] for x in reps)
                    or all(x["served"] > 0 for x in reps)):
                break
            time.sleep(0.05)
        n = ref.shape[0]
        futs = [(i, router.submit([i % n, (i * 3) % 200]))
                for i in range(60)]
        ok = timeouts = 0
        for i, fut in futs:
            try:
                rows = fut.result(timeout=60)
                _rows_check("sigkill", np.asarray(rows),
                            ref[[i % n, (i * 3) % 200]], FLEET_TOL)
                ok += 1
                answered.add(fut.rid)
            except ServeTimeout:
                timeouts += 1
        stats = router.stats()
    alive = [x["alive"] for x in stats["replicas"]]
    fo = [e for e in events if e.get("cat") == "serve"
          and e.get("kind") == "failover" and e.get("replica") == 1]
    rec = {"ok": ok, "timeouts": timeouts, "alive": alive,
           "failover_events": len(fo), "n_failover": stats["n_failover"],
           # the requests this fleet requeued and then answered, in
           # submission order (a rid is ``<pid hex>-<sequence>``): the
           # first was in flight on replica 1 when it died, a later one
           # may have been sent to it after
           "requeued_rids": sorted({r for e in fo
                                    for r in e.get("rids") or []}
                                   & answered,
                                   key=lambda r: int(r.rsplit("-", 1)[1]))}
    if (ok + timeouts != 60 or not ok or alive != [True, False] or not fo
            or not stats["n_failover"]):
        raise AssertionError(f"drill replica_sigkill: {rec}")
    return rec


def _drill_stall(art, ref, scale, events, closing):
    """The wedged fleet's router goes to ``closing``: its close, which
    waits out the wedged replica (drain timeout, TERM, KILL), runs later
    beside other work (:func:`close_wedged`)."""
    from roc_tpu_torch.serve.errors import ServeTimeout
    from roc_tpu_torch.serve.router import Router
    t0 = time.perf_counter()
    # one request warms each replica (replica 0's microbatch 1) and the
    # hedge keys on the median round trip, so cold first round trips on
    # a loaded host cannot push the threshold past the deadline
    router = Router(art, n_replicas=2, env=_fleet_env(FLEET_DRILLS[1]),
                    default_deadline_ms=30_000.0, hedge_min_ms=150.0,
                    hedge_pct=0.5, replica_args=FLEET_ARGS)
    try:
        for p in [router.submit([0]) for _ in range(2)]:
            p.result(timeout=60)
        futs = []
        for i in range(40):
            futs.append((i, router.submit([i])))
            time.sleep(0.003)
        ok = timeouts = 0
        for i, fut in futs:
            try:
                _rows_check("stall", np.asarray(fut.result(timeout=60)),
                            ref[[i]], FLEET_TOL)
                ok += 1
            except ServeTimeout:
                timeouts += 1
        stats = router.stats()
    except BaseException:
        router.close()
        raise
    closing.append(router)
    rec = {"ok": ok, "timeouts": timeouts, "n_hedge": stats["n_hedge"],
           "hedge_events": sum(1 for e in events if e.get("kind") == "hedge"),
           "seconds": time.perf_counter() - t0}
    if ok + timeouts != 40 or not ok or not stats["n_hedge"]:
        raise AssertionError(f"drill replica_stall: {rec}")
    return rec


def close_wedged(routers):
    """Close the wedged fleets: seconds each took, and a gate that every
    replica process ended."""
    out = []
    for r in routers:
        t0 = time.perf_counter()
        r.close()
        out.append(time.perf_counter() - t0)
        if not all(x.proc.poll() is not None for x in r.replicas):
            raise AssertionError("drill replica_stall: a replica outlived "
                                 "its router's close")
    return out


def _drill_serve_io(art, ref, scale, events):
    from roc_tpu_torch.serve.router import Router
    # no hedge: a hedge answering first (a cold replica's first batch)
    # would drop the failing replica's retryable error unredispatched
    with Router(art, n_replicas=2, env=_fleet_env(FLEET_DRILLS[2]),
                default_deadline_ms=30_000.0, slos=list(FLEET_SLOS),
                hedge_min_ms=NO_HEDGE_MS,
                replica_args=FLEET_ARGS) as router:
        futs = [router.submit([i]) for i in range(30)]
        for i, f in enumerate(futs):
            _rows_check("serve_io", np.asarray(f.result(timeout=60)),
                        ref[[i]], FLEET_TOL)
        stats = router.stats()
        health = router.health()
    redispatch = sum(1 for e in events if e.get("kind") == "redispatch")
    rec = {"n_ok": stats["n_ok"], "n_failed": stats["n_failed"],
           "redispatch_events": redispatch,
           "health": {"ok": health["ok"],
                      "replicas_alive": health["replicas_alive"],
                      "states": health["states"],
                      "objectives": [{k: o[k] for k in (
                          "name", "value", "target", "burn", "compliant")}
                          for o in health["objectives"]]}}
    if (stats["n_ok"] != 30 or stats["n_failed"] or not redispatch
            or len(health["objectives"]) != len(FLEET_SLOS)):
        raise AssertionError(f"drill serve_io: {rec}")
    return rec


def _drill_swap(art, ref, ref_new, scale):
    from roc_tpu_torch.serve.router import Router
    versions, matched = set(), {"old": 0, "new": 0}
    tol = FLEET_TOL * max(scale, 1.0)
    # no hedge: replica 1 answering first would hide replica 0's swap;
    # after the burst, requests one at a time go to the idle replica 0,
    # past the swap
    with Router(art, n_replicas=2, env=_fleet_env(FLEET_DRILLS[3]),
                default_deadline_ms=30_000.0, hedge_min_ms=NO_HEDGE_MS,
                replica_args=FLEET_ARGS) as router:
        futs = [router.submit([i]) for i in range(200)]
        for i, f in enumerate(futs):
            rows = f.result(timeout=60)
            versions.add(int(rows.version))
            # a torn batch would match neither version
            for tag, want in (("old", ref[[i]]), ("new", ref_new[[i]])):
                if np.abs(np.asarray(rows) - want).max() <= tol:
                    matched[tag] += 1
                    break
            else:
                raise AssertionError(f"drill table_swap_mid_query: row {i} "
                                     f"matches neither version")
        for i in range(4):
            rows = router.submit([i]).result(timeout=60)
            versions.add(int(rows.version))
            if np.abs(np.asarray(rows) - ref_new[[i]]).max() > tol:
                raise AssertionError(f"drill table_swap_mid_query: row {i} "
                                     f"after the swap")
        stats = router.stats()
    rec = {"n_ok": stats["n_ok"], "versions": sorted(versions), **matched}
    if stats["n_ok"] != 204 or versions != {0, 1}:
        raise AssertionError(f"drill table_swap_mid_query: {rec}")
    return rec


def _drill_sigterm(art):
    """SIGTERM to a replica serving requests: it answers them, writes
    ``drained`` with ``clean: true`` and exits 0.  The replica answers
    one request first, so its CUDA start (seconds on a loaded host) does
    not fall inside the drain's 3 s timeout (FLEET_ARGS)."""
    here = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.Popen([sys.executable, "-m", "roc_tpu_torch.serve.replica",
                          art, "--replica", "0"] + FLEET_ARGS,
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.DEVNULL, text=True, cwd=here,
                         env=dict(_fleet_env(), PYTHONPATH=here))
    try:
        lines = []

        def read_until(kind, n=1):
            got = 0
            for line in p.stdout:
                msg = json.loads(line)
                lines.append(msg)
                got += msg["kind"] == kind
                if got == n:
                    return
            raise AssertionError(f"drill sigterm: EOF before {kind}")
        read_until("ready")
        p.stdin.write(json.dumps({"kind": "req", "id": 5, "ids": [0],
                                  "deadline_ms": None, "rid": None}) + "\n")
        p.stdin.flush()
        read_until("res")
        for i in range(5):
            p.stdin.write(json.dumps({"kind": "req", "id": i, "ids": [i],
                                      "deadline_ms": None, "rid": None})
                          + "\n")
        p.stdin.flush()
        p.send_signal(signal.SIGTERM)
        read_until("drained")
        rc = p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    res = [m for m in lines if m["kind"] == "res" and m["id"] != 5]
    drained = lines[-1]
    rec = {"rc": rc, "answered": sum(1 for m in res if m["ok"]),
           "failed_typed": [m["error"] for m in res if not m["ok"]],
           "drained": drained}
    if rc != 0 or drained.get("clean") is not True or len(res) != 5:
        raise AssertionError(f"drill sigterm: {rec}")
    return rec


def fleet_drills(art, ref, ref_new, closing, sigkill_events=None):
    """The four serve drills, each on its own unsharded 2-replica fleet
    on this card, and the SIGTERM drain, all at once (their spawns
    dominate); every one a gate.  The stalled fleet's router is left in
    ``closing``; the SIGKILL fleet's replicas write their events to
    ``sigkill_events``."""
    import concurrent.futures as cf
    from roc_tpu_torch.obs.events import get_bus
    scale = float(np.abs(ref).max())
    sink = _EventSink()
    bus = get_bus()
    bus.add_sink(sink)
    try:
        with cf.ThreadPoolExecutor(5) as pool:
            futs = {
                "replica_sigkill": pool.submit(_drill_sigkill, art, ref,
                                               scale, sink, sigkill_events),
                "replica_stall": pool.submit(_drill_stall, art, ref, scale,
                                             sink, closing),
                "serve_io": pool.submit(_drill_serve_io, art, ref, scale,
                                        sink),
                "table_swap_mid_query": pool.submit(_drill_swap, art, ref,
                                                    ref_new, scale),
                "sigterm": pool.submit(_drill_sigterm, art)}
            return {k: f.result() for k, f in futs.items()}
    finally:
        bus.sinks.remove(sink)


def _merge_trace(files, out, rid):
    """``python -m roc_tpu_torch.timeline files -o out --request rid``,
    started (a Popen)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-m", "roc_tpu_torch.timeline", *files, "-o", out,
         "--request", rid], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=here, env=dict(_fleet_env(), PYTHONPATH=here))


def _trace_lanes(doc, records):
    """``{proc: pid}`` of a merged doc's lanes, and the skew of each lane's
    clock offset from the router lane's (proc 0), in ms: on one host every
    process's wall minus monotonic clock is one number, so the skew is
    the merge's own error (the stamps' ``t`` has ms resolution)."""
    from roc_tpu_torch.obs.timeline import clock_offsets
    pids = {p["proc"]: p["pid"] for p in doc["roc_tpu"]["processes"]}
    offs = {k[1]: v for k, v in clock_offsets(records).items()}
    skew = {p: abs(offs[p] - offs[0]) * 1e3 for p in offs if p != 0}
    return pids, skew


def _within(e, route, tol_ms):
    lo = route["ts_ms"] - tol_ms
    hi = route["ts_ms"] + route["dur_ms"] + tol_ms
    return lo <= e["ts_ms"] and e["ts_ms"] + (e["dur_ms"] or 0.0) <= hi


def fleet_traces(router_ev, akx_ev, kill_ev, seam_rids, size_rids,
                 requeued, root):
    """Each armed fleet's files merged by ``python -m
    roc_tpu_torch.timeline`` (the router process's file holds every
    router of this process: rids are unique per process).  Gates: exit
    0; one lane per process (1 + replicas), each aligned, its skew from
    the router lane under FLEET_SKEW_MS; ``--request`` on the seam
    request one connected trace over the router's and both replicas'
    lanes, each replica span inside the router span to within the skew
    (at least the stamps' 1 ms) — the seam batch sent once more after
    the latency runs (``seam_rids['warm']``; the trace of the first,
    cold one, ``seam_rids['seam']``, is printed); on the first requeued
    request of the SIGKILL fleet (in submission order: one in flight
    when replica 1 died) the failover marker naming replica 1, the dead
    replica's fault marker and a span on the survivor, inside the router
    span.  Prints
    per request size the medians of the router span, the replica span
    (the longer of a split request's two) and the gap between them."""
    from roc_tpu_torch.obs.timeline import load_jsonl, request_trace
    if not requeued:
        raise AssertionError("fleet trace: the SIGKILL drill answered no "
                             "requeued request")
    t0 = time.perf_counter()
    jobs = {"akx_fp32": ([router_ev, akx_ev], seam_rids["warm"]),
            "sigkill": ([router_ev, kill_ev], requeued[0])}
    procs = {k: _merge_trace(f, os.path.join(root, f"trace_{k}.json"), r)
             for k, (f, r) in jobs.items()}
    rec, failed = {}, []
    for k, pr in procs.items():
        out, err = pr.communicate(timeout=300)
        if pr.returncode != 0:
            raise AssertionError(f"fleet trace {k}: the merge exited "
                                 f"{pr.returncode}: {err[-2000:]}")
        summary = json.loads(out.strip().splitlines()[-1])
        with open(os.path.join(root, f"trace_{k}.json")) as f:
            doc = json.load(f)
        records = [r for p in jobs[k][0] for r in load_jsonl(p)]
        pids, skew = _trace_lanes(doc, records)
        tol = max(1.0, max(skew.values(), default=0.0))
        tr = summary["request"]
        routes = [e for e in tr["events"] if e["name"] == "route_request"]
        batches = [e for e in tr["events"] if e["name"] == "serve_batch"]
        r = {"processes": summary["processes"], "lanes": sorted(pids),
             "aligned": all(p["aligned"]
                            for p in doc["roc_tpu"]["processes"]),
             "skew_ms": skew, "rid": tr["rid"], "connected": tr["connected"],
             "trace_lanes": tr["lanes"], "trace_span_ms": tr["span_ms"],
             "batch_lanes": sorted({e["pid"] for e in batches})}
        ok = (summary["processes"] == 1 + FLEET_SHARDS
              and sorted(pids) == list(range(1 + FLEET_SHARDS))
              and r["aligned"] and max(skew.values()) < FLEET_SKEW_MS
              and tr["connected"] and len(routes) == 1
              and all(_within(e, routes[0], tol) for e in batches))
        if k == "akx_fp32":
            ok = ok and (len(tr["lanes"]) == 1 + FLEET_SHARDS
                         and r["batch_lanes"] == sorted([pids[1], pids[2]]))
            r["split"] = _trace_split(doc, size_rids)
            cold = request_trace(doc, seam_rids["seam"])
            r["cold_seam"] = {"connected": cold["connected"],
                              "lanes": cold["lanes"],
                              "span_ms": cold["span_ms"],
                              "events": _trace_events(cold)}
        else:
            fo = [e for e in tr["events"] if e["name"] == "serve:failover"]
            dead = [e for e in doc["traceEvents"]
                    if e.get("pid") == pids[2]
                    and e.get("name") == "fault:replica_sigkill"]
            r["failover_replica"] = [e["args"].get("replica") for e in fo]
            r["dead_fault_in_route"] = bool(dead and routes and _within(
                {"ts_ms": dead[0]["ts"] / 1e3, "dur_ms": 0.0}, routes[0],
                tol))
            ok = ok and (r["failover_replica"] == [1]
                         and r["batch_lanes"] == [pids[1]]
                         and r["dead_fault_in_route"])
        rec[k] = r
        if not ok:
            r["events"] = _trace_events(tr)
            failed.append(k)
    rec["seconds"] = time.perf_counter() - t0
    if failed:
        raise AssertionError(f"fleet trace {failed}: {rec}")
    return rec


def _trace_events(tr):
    """A request trace's events, short: name, lane, start and length."""
    return [(e["name"], e["pid"], e["ts_ms"], e["dur_ms"])
            for e in tr["events"]]


def _trace_split(doc, size_rids):
    """Per request size: the medians of the router's route_request span,
    the replica serve_batch span that served it (the longest, for a
    request split between the replicas) and the gap (wire, queues and
    the router), in ms."""
    routes, batches = {}, {}
    for e in doc["traceEvents"]:
        args = e.get("args") or {}
        if e.get("name") == "route_request" and "rid" in args:
            routes[args["rid"]] = e["dur"] / 1e3
        elif e.get("name") == "serve_batch":
            for rid in args.get("rids") or []:
                batches[rid] = max(batches.get(rid, 0.0), e["dur"] / 1e3)
    out = {}
    for n in sorted({n for n, _ in size_rids}):
        got = [(routes[r], batches[r]) for m, r in size_rids
               if m == n and r in routes and r in batches]
        if got:
            rt, rb = np.array(got).T
            out[n] = {"n": len(got), "router_ms": float(np.median(rt)),
                      "replica_ms": float(np.median(rb)),
                      "gap_ms": float(np.median(rt - rb))}
    return out


def fleet_child(data_dir, params_path, out_path):
    """Phase 18 in a fresh process on card 0: the sharded exports of
    :func:`fleet_exports` (counted); the capacity refusal in the
    background; the drills and the sharded refresh at the arxiv shape
    (SGC 128-40, k = 2); then a ``Router(sharded=True)`` on each export
    with the replicas' table budget at FLEET_BUDGET of the full table
    (answers, latency beside the in-process Server) while the wedged
    drill fleet closes; writes the record and the counts."""
    import concurrent.futures as cf

    import torch
    from roc_tpu_torch.core.graph import synthetic_dataset
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.models.sgc import build_sgc
    from roc_tpu_torch.obs.events import JsonlSink, get_bus
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    from roc_tpu_torch.serve.export import (build_predictor, export_predictor,
                                            load_predictor)
    from roc_tpu_torch.serve.router import Router
    from roc_tpu_torch.train.trainer import TrainConfig
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    # built before any replica starts: replicas never race a first build
    _build.library()
    counts = Launches(torch)
    saved = torch.load(params_path, map_location="cuda")
    ds = _map_dataset(data_dir, LAYERS[-1])
    rec = {}
    closing = []
    with tempfile.TemporaryDirectory() as root, \
            cf.ThreadPoolExecutor(4) as pool:
        # Reddit's shape: the exports (counted); the whole akx table under
        # the slices' budget, checked in the background
        t0 = time.perf_counter()
        rec["exports"], arts = fleet_exports(torch, ds, saved["akx"],
                                             saved["gcn"], counts, root)
        rec["exports"]["seconds"] = time.perf_counter() - t0
        log({"phase": "fleet_exports", **rec["exports"]})
        cap = pool.submit(fleet_capacity, arts["akx_fp32"][1], int(
            FLEET_BUDGET * arts["akx_fp32"][2]["shards"]["bytes_full"]))
        # the merged traces' files: this (the routers') process, the
        # SIGKILL fleet's replicas, the sharded fp32 akx fleet's replicas
        ev = {k: os.path.join(root, f"ev_{k}.jsonl")
              for k in ("router", "sigkill", "akx_fp32")}
        router_sink = JsonlSink(ev["router"])
        get_bus().add_sink(router_sink)
        trace_rids = {"seam": {}, "sizes": []}
        try:
            # the arxiv shape: the drills on replicas, the refresh in
            # this process, both on one exported artifact (no export
            # runs beside the drills: their hedges key on measured
            # latency)
            t0 = time.perf_counter()
            ads = synthetic_dataset(ZOO_V, ZOO_DEGREE,
                                    in_dim=ZOO_LAYERS[0],
                                    num_classes=ZOO_LAYERS[-1], seed=SEED,
                                    name="arxiv_shape")
            model = build_sgc([ZOO_LAYERS[0], ZOO_LAYERS[-1]], k=2)
            params = model.init_params(
                torch.Generator(device="cuda").manual_seed(SEED + 60),
                device="cuda")
            pred = build_predictor(model, ads, TrainConfig(
                aggr_impl="cuda", symmetric=True, seed=SEED), params=params)
            art = os.path.join(root, "arxiv")
            man = export_predictor(pred, art, shards=FLEET_SHARDS)
            allv = np.arange(pred.num_nodes)
            ref = pred.query(allv)
            swapped = load_predictor(art)
            swapped.invalidate([0], [0])
            ref_new = swapped.query(allv)
            del swapped, ads
            rec["arxiv_setup_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            drills = pool.submit(fleet_drills, art, ref, ref_new, closing,
                                 ev["sigkill"])
            rec["refresh"] = fleet_refresh(torch, pred, art, man)
            log({"phase": "fleet_refresh", **rec["refresh"]})
            rec["drills"] = drills.result()
            rec["drills_s"] = time.perf_counter() - t0
            log({"phase": "fleet_drills", **rec["drills"],
                 "seconds": rec["drills_s"]})
            del pred
            torch.cuda.empty_cache()
        finally:
            # the wedged fleet ends while the sharded fleets start
            wedged = pool.submit(close_wedged, list(closing))
        rec["capacity"] = cap.result()
        log({"phase": "fleet_capacity", **rec["capacity"]})

        def start(name):
            pred, path, man = arts[name]
            b = int(FLEET_BUDGET * man["shards"]["bytes_full"])
            env = _fleet_env()
            if name in ev:
                env["ROC_TPU_EVENTS"] = ev[name]
            t = time.perf_counter()
            r = Router(path, n_replicas=FLEET_SHARDS, sharded=True,
                       table_budget_bytes=b, replica_args=FLEET_ARGS,
                       env=env)
            return r, time.perf_counter() - t
        t0 = time.perf_counter()
        started = {n: pool.submit(start, n) for n in arts}
        cf.wait(list(started.values()))
        rec["fleet_start_s"] = time.perf_counter() - t0
        routers = {n: f.result() for n, f in started.items()
                   if f.exception() is None}
        try:
            for f in started.values():
                if f.exception() is not None:
                    raise f.exception()
            for i, (name, (router, up_s)) in enumerate(routers.items()):
                pred, path, man = arts[name]
                seam = man["shards"]["plan"][0][1]
                traced = name in ev
                warm = [x.ready.get("warm") for x in router.replicas]
                if not all(w and w["failed"] == 0
                           and w["programs"] == len(pred.buckets)
                           for w in warm):
                    raise AssertionError(f"{name}: a replica did not warm "
                                         f"every bucket before ready: "
                                         f"{warm}")
                r = {"ready_s": up_s, "replica_warm": warm,
                     # each bucket's first request through this router,
                     # before any other (the replicas warmed before ready)
                     "first_ms": fleet_first(router, pred.num_nodes,
                                             pred.buckets),
                     "table_bytes": [x.ready["table_bytes"]
                                     for x in router.replicas],
                     "checks": fleet_answers(
                         name, pred, router, seam,
                         trace_rids["seam"] if traced else None),
                     **fleet_latency(pred, router, SEED + 64 + i,
                                     trace_rids["sizes"] if traced
                                     else None)}
                if traced:
                    # the traced seam request, on warm replicas (the
                    # answers' first requests pay the replicas' start)
                    fut = router.submit(np.arange(seam - FLEET_SEAM,
                                                  seam + FLEET_SEAM))
                    fut.result(timeout=300)
                    trace_rids["seam"]["warm"] = fut.rid
                rec[name] = r
                log({"phase": "fleet_sharded", "artifact": name, **r})
                log({"phase": "fleet_first_request", "artifact": name,
                     "first_ms": r["first_ms"],
                     "steady_median_ms": r["router_median_ms"],
                     "replica_warm": warm, "card": card_line()})
        finally:
            list(pool.map(lambda rt: rt[0].close(), routers.values()))
            rec["stall_close_s"] = wedged.result()
            log({"phase": "fleet_stall_close",
                 "seconds": rec["stall_close_s"]})
            get_bus().sinks.remove(router_sink)
            router_sink.close()
        # every traced router and replica has closed: its spans are out
        rec["traces"] = fleet_traces(
            ev["router"], ev["akx_fp32"], ev["sigkill"],
            trace_rids["seam"], trace_rids["sizes"],
            rec["drills"]["replica_sigkill"]["requeued_rids"], root)
        log({"phase": "fleet_traces", **rec["traces"], "card": card_line()})
    rec["seconds"] = time.perf_counter() - t_start
    log({"phase": "fleet_seconds", "total": rec["seconds"],
         "exports": rec["exports"]["seconds"],
         "fleet_start": rec["fleet_start_s"],
         "arxiv_setup": rec["arxiv_setup_s"], "drills": rec["drills_s"],
         "traces": rec["traces"]["seconds"]})
    with open(out_path, "w") as f:
        json.dump({"record": rec, "counted": counts.counted}, f)


def _prewarm_cli(cache, *extra):
    """``python -m roc_tpu_torch.prewarm --config all`` against ``cache``
    in a fresh process on the card: its JSON lines, its wall, the cache's
    files before and after."""
    here = os.path.dirname(os.path.abspath(__file__))
    before = sorted(os.listdir(cache)) if os.path.isdir(cache) else []
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "roc_tpu_torch.prewarm",
                        "--config", "all", "--cache-dir", cache, *extra],
                       capture_output=True, text=True, timeout=300,
                       cwd=here, env=dict(os.environ, PYTHONPATH=here))
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"prewarm CLI exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    lines = [json.loads(x) for x in r.stdout.splitlines()
             if x.startswith("{")]
    after = sorted(n for n in os.listdir(cache) if not n.startswith("."))
    return {"wall_s": wall, "lines": lines,
            "new_files": sorted(set(after) - set(before)),
            "configs": [x["config"] for x in lines],
            "skipped": [x["config"] for x in lines if x.get("skipped")],
            "library_builds": sum(bool(x.get("library_cold"))
                                  for x in lines),
            "cold": sum(x.get("compile_cold", 0) for x in lines),
            "warm": sum(x.get("compile_warm_hits", 0) for x in lines),
            "failed": sum(x.get("failed", 0) for x in lines),
            "library_s": sum(x.get("library_s", 0) for x in lines),
            "instances_match": all(x.get("instances_match", True)
                                   for x in lines)}


def _first_launches(torch):
    """Each kernel's first launch in this process (lazy CUDA module
    loading loads its module there) and its second, in ms, synchronised,
    on a small input."""
    from roc_tpu_torch.core.ell import ell_from_graph
    from roc_tpu_torch.core.graph import from_edge_list
    from roc_tpu_torch.core.partition import padded_edge_list
    from roc_tpu_torch.kernels import ell_spmm, graphnorm, spmm
    rng = np.random.RandomState(5)
    n, F = 1003, 64
    g = from_edge_list(rng.randint(0, n, 8000), rng.randint(0, n, 8000), n)
    t = ell_from_graph(g.row_ptr, g.col_idx, n)
    dev = torch.device("cuda")
    idx = tuple(torch.from_numpy(a[0]).to(dev) for a in t.idx)
    rid = tuple(torch.from_numpy(a[0]).to(dev) for a in t.row_id)
    deg = torch.from_numpy(g.in_degree).to(dev)
    esrc, edst = (torch.from_numpy(a).to(dev)
                  for a in padded_edge_list(g, multiple=512))
    x = torch.randn(n, F, device=dev)
    s = torch.rand(n, device=dev)
    torch.cuda.synchronize()
    out = {}
    for name, fn in (
            ("indegree_norm", lambda: graphnorm.indegree_norm(x, deg)),
            ("indegree_norm_masked",
             lambda: graphnorm.indegree_norm(x, deg, relu_out=x)),
            ("scale_act", lambda: graphnorm.scale_act(x, s, "relu")),
            ("ell_aggregate",
             lambda: ell_spmm.ell_aggregate(x, idx, rid, n)),
            ("csr_spmm", lambda: spmm.csr_spmm(x, esrc, edst, n))):
        ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"first_ms": ms[0], "second_ms": ms[1]}
    return out


def _warm_gcn(torch, ds, params, mode, counts, key):
    """Phase 6's GCN 602-256-41 at Reddit's shape on 'cuda' (dropout 0.5)
    warmed (utils/prewarm.py ``warm_trainer``) against the build cache in
    use, and its unwarmed twin: the enumerated kernel instances equal the
    launched ones (K1, the masked K1, K2 and K4, each at its F and slice
    width), the params and Adam state are bit-equal after the warm, and
    the next step's objective is the twin's bit for bit.  The warm and
    both steps are counted (the counts zeroed just before, read just
    after)."""
    from roc_tpu_torch.utils.prewarm import warm_trainer
    tr = _trainer(ds, "cuda", 0.5, params, mode)
    twin = _trainer(ds, "cuda", 0.5, params, mode)
    before = {k: v.detach().clone() for k, v in tr.params.items()}
    st = tr.opt_state
    mv = [{k: v.clone() for k, v in d.items()} for d in (st.m, st.v)]
    counts.zero()
    t0 = time.perf_counter()
    rep = warm_trainer(tr, name=f"gcn_{mode}")
    warm_s = time.perf_counter() - t0
    st2 = tr.opt_state
    state_equal = (
        all(torch.equal(before[k], v) for k, v in tr.params.items())
        and all(torch.equal(mv[0][k], st2.m[k]) and
                torch.equal(mv[1][k], st2.v[k]) for k in st2.m)
        and (st2.step, st2.beta1_t, st2.beta2_t) ==
        (st.step, st.beta1_t, st.beta2_t))
    lr = TRAIN["learning_rate"]
    t0 = time.perf_counter()
    a = tr.step(lr)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = twin.step(lr)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    launches = counts.read(key)
    rec = {"mode": mode, "warm_s": warm_s, "failed": rep["failed"],
           "slots": [{k: r[k] for k in ("slot", "run_s", "library_s",
                                         "cold", "instances", "launched",
                                         "instances_match")}
                     for r in rep["slots"]],
           "instances_match": rep["instances_match"],
           "state_bit_equal": state_equal, "objective": float(a),
           "twin_objective": float(b),
           "objective_bit_equal": bool(torch.equal(a, b)),
           "first_step_after_warm_s": step_s,
           "twin_first_step_s": twin_s, "launches": launches}
    want = {"indegree_norm", "indegree_norm_masked", "scale_act",
            "ell_aggregate"}
    got = {i.split("[")[0] for r in rep["slots"] for i in r["launched"]}
    if rep["failed"] or not rep["instances_match"] or got != want:
        raise AssertionError(f"warm {mode}: {rec['slots']}")
    if not state_equal:
        raise AssertionError(f"warm {mode}: the params or the Adam state "
                             f"moved")
    if not rec["objective_bit_equal"]:
        raise AssertionError(f"warm {mode}: the next objective {float(a)} "
                             f"!= the twin's {float(b)}")
    del tr, twin
    torch.cuda.empty_cache()
    return rec


def prewarm_child(data_dir, out_path):
    """Phase 20 in a fresh process on card 0, in fresh temporary build
    caches: (a) ``python -m roc_tpu_torch.prewarm --config all`` cold
    (exactly one library build, its seconds), (b) again, all warm with no
    new file and no build, each process timed, each rig's enumerated instances equal
    to its launched ones; (c) each kernel's first and second launch in
    this process; (d) ``warm_trainer`` on the GCN at Reddit's shape in
    fp32 and 'mixed' (:func:`_warm_gcn`); (e) a truncated library in a
    third cache is rebuilt (cold) and K1-K4 hold their plain versions as
    in phase 3.  Writes the record and the counts."""
    import torch
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    from roc_tpu_torch.utils.compile_cache import enable_compile_cache
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    t_start = time.perf_counter()
    rec = {}
    counts = Launches(torch)
    root = tempfile.mkdtemp(prefix="chip_smoke_prewarm_")
    try:
        rec["first_launch"] = _first_launches(torch)
        log({"phase": "prewarm_first_launch", **rec["first_launch"]})
        cache = os.path.join(root, "cache")
        rec["cold"] = _prewarm_cli(cache)
        rec["warm"] = _prewarm_cli(cache, "--no-state")
        for tag in ("cold", "warm"):
            r = rec[tag]
            log({"phase": f"prewarm_{tag}",
                 **{k: v for k, v in r.items() if k != "lines"},
                 "lines": [{k: x.get(k) for k in (
                     "config", "programs", "library_cold", "compile_cold",
                     "compile_warm_hits", "failed", "prewarm_s",
                     "library_s", "instances_match", "skipped")}
                     for x in r["lines"]], "card": card_line()})
        lib = os.path.basename(_build.library_path())
        c, w = rec["cold"], rec["warm"]
        if c["library_builds"] != 1 or lib not in c["new_files"] or \
                c["failed"]:
            raise AssertionError(f"prewarm cold: not one build: {c}")
        if w["library_builds"] or w["cold"] or w["new_files"] or \
                w["failed"] or w["warm"] != c["cold"] + c["warm"]:
            raise AssertionError(f"prewarm warm: {w}")
        if not (c["instances_match"] and w["instances_match"]):
            raise AssertionError("prewarm: a rig's launched kernel "
                                 "instances differ from its enumerated")
        # (d) the GCN at Reddit's shape, warmed against this cache
        enable_compile_cache(cache)
        _build.reset()
        ds = _map_dataset(data_dir, LAYERS[-1])
        params = _gcn_params(torch)
        rec["gcn"] = {}
        for mode, key in TELEMETRY_MODES:
            rec["gcn"][mode] = r = _warm_gcn(torch, ds, params, mode,
                                             counts, key)
            log({"phase": "prewarm_gcn", **r, "card": card_line()})
        # (e) a truncated library in a third cache: rebuilt, cold
        bad = os.path.join(root, "cache3")
        os.makedirs(bad)
        src = _build.library_path()
        with open(src, "rb") as f:
            head = f.read(4096)
        enable_compile_cache(bad)
        with open(_build.library_path(), "wb") as f:
            f.write(head)
        _build.reset()
        _build.rebuilt = False
        t0 = time.perf_counter()
        _build.library()
        rebuild_s = time.perf_counter() - t0
        if not _build.rebuilt or \
                os.path.getsize(_build.library_path()) <= len(head):
            raise AssertionError("the truncated library was not rebuilt")
        rec["rebuild"] = {"seconds": rebuild_s,
                          "bytes": os.path.getsize(_build.library_path()),
                          "truncated_bytes": len(head),
                          "ragged": ragged_checks(torch,
                                                  torch.device("cuda"))}
        log({"phase": "prewarm_rebuild", **rec["rebuild"],
             "card": card_line()})
    finally:
        import shutil
        shutil.rmtree(root, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_start
    with open(out_path, "w") as f:
        json.dump({"record": rec, "counted": counts.counted}, f)


def start_prewarm_child(tmp):
    """:func:`prewarm_child` pre-started on the Reddit shape under
    ``tmp``/reddit, writing ``tmp``/prewarm.json."""
    data = os.path.join(tmp, "reddit")
    out = os.path.join(tmp, "prewarm.json")
    return _Child(f"prewarm_child({data!r}, {out!r})", 600,
                  "phase 20 (prewarm)")


# phase 21's recorded steps: the route and dtype mode of each
LINT_RUNS = (("cuda", "float32"), ("cuda", "mixed"), ("cuda_csr", "mixed"))


def _sync_warnings(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode('warn')``,
    synchronised after: its result and the messages of the
    synchronizing-operation warnings it raised."""
    import warnings
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out, [str(w.message)[:200] for w in got
                 if "called a synchronizing" in str(w.message)]


def _lint_run(torch, ds, params, impl, mode, counts, baseline):
    """One of phase 21's runs: the GCN 602-256-41 at Reddit's shape on
    ``impl`` in ``mode``, dropout 0: one train step and one eval step
    (``eval_sums``, its device work) recorded (analysis/step_trace.py)
    through the program-space candidates' ``run``, which restores the
    trainer after each, then the same train step unrecorded (its
    objective bit-equal to the recorded one's).  The recording's kernel
    entries equal the launches around it, instance by instance and
    count by count, the backward's from the autograd thread included,
    and its instances the enumerated ones (analysis/programspace.py
    ``step_instances``); the jaxpr and HLO rules run at the
    card's V * F, every finding printed and held to the port's baseline;
    the sync warnings of ``set_sync_debug_mode('warn')`` over each
    recorded step equal the syncs ``jaxpr-host-callback`` finds, and over
    the whole ``evaluate`` (its host fetch) too.  Counted."""
    from roc_tpu_torch.analysis.hlo_lint import (check_bytes_model,
                                                 check_large_copy)
    from roc_tpu_torch.analysis.jaxpr_lint import (StepUnit,
                                                   run_jaxpr_lint,
                                                   sync_entries)
    from roc_tpu_torch.analysis.programspace import (candidate_programs,
                                                     step_instances)
    from roc_tpu_torch.analysis.step_trace import record
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.train.trainer import card_kind
    key = F32 if mode == "float32" else BF16
    tr = _trainer(ds, impl, 0.0, params, mode)
    cands = {c.slot: c for c in candidate_programs(tr)}
    counts.zero()
    traces, syncs, walls, sync_msgs = {}, {}, {}, {}

    def rec(slot):
        def go(fn):
            before = _build.instances_launched()
            t0 = time.perf_counter()
            t, msgs = _sync_warnings(torch, lambda: record(
                fn, args_of=lambda: tr.step_args(slot)))
            syncs[slot] = len(msgs)
            if msgs:
                sync_msgs[slot] = msgs
            walls[f"{slot}_recorded_ms"] = (time.perf_counter() - t0) * 1e3
            # every launch around the call, per instance, repeats kept:
            # the recording must hold each (the backward's, on the
            # autograd thread, share the forward's names)
            now = _build.instances_launched()
            t.launched = {k: n - before.get(k, 0) for k, n in now.items()
                          if n > before.get(k, 0)}
            traces[slot] = t
            return t.result
        return go

    def plain(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls["train_step_plain_ms"] = (time.perf_counter() - t0) * 1e3
        return out
    # unrecorded, recorded, unrecorded: the first pays the kernels' and
    # the allocator's first use, the last is the plain step timed beside
    # the recorded one
    first = cands["train_step"].run(record=plain)
    for slot in ("train_step", "eval_step"):
        cands[slot].run(record=rec(slot))
    loss = cands["train_step"].run(record=plain)
    # the witness: the whole eval, its host fetch of the metrics included
    witness = {}
    got, msgs = _sync_warnings(torch, lambda: record(tr.evaluate))
    witness["warnings"], witness["messages"] = len(msgs), msgs
    V, F = ds.graph.num_nodes, LAYERS[0]
    ctx = dict(compute_dtype="bfloat16" if mode == "mixed" else "float32",
               num_nodes=V, vf_elems=V * F, halo="gather",
               donate_min_bytes=max(v.numel() * v.element_size()
                                    for v in tr.params.values()))
    units = [StepUnit("train_step", traces["train_step"], donate=(0, 1),
                      **ctx),
             StepUnit("eval_step", traces["eval_step"], **ctx)]
    witness["syncs"] = len(sync_entries(StepUnit("evaluate", got, **ctx)))
    t = traces["train_step"]
    findings = (run_jaxpr_lint(units)
                + check_large_copy("hlo:train_step", t, V * F)
                + check_bytes_model("hlo:train_step", t.bytes_total,
                                    tr.modeled_bytes))
    enumerated = sorted(step_instances(tr, "train_step", card_kind(tr.device)))
    rec_ = {
        "impl": impl, "mode": mode, "walls_ms": walls,
        "objective_bit_equal": bool(torch.equal(t.result, loss)
                                    and torch.equal(first, loss)),
        "objective": float(loss),
        "entries": {s: len(x.entries) for s, x in traces.items()},
        "kernels": {s: x.kernels() for s, x in traces.items()},
        "launched": {s: x.launched for s, x in traces.items()},
        "enumerated": enumerated,
        "kernel_threads": sorted({e.thread for e in t.entries if e.kernel}),
        "recorded_bytes": t.bytes_total, "modeled_bytes": tr.modeled_bytes,
        "bytes_ratio": t.bytes_total / tr.modeled_bytes,
        "sync_warnings": syncs, "sync_messages": sync_msgs,
        "syncs_found": {u.name: len(sync_entries(u)) for u in units},
        "witness": witness,
        "findings": [f.render() for f in findings],
        "unbaselined": [f.fingerprint for f in findings
                        if f.fingerprint not in baseline],
        "launches": counts.read(key)}
    want = {"indegree_norm", "indegree_norm_masked", "scale_act"} | (
        {"ell_aggregate"} if impl == "cuda" else {"csr_spmm", "csr_row_ptr"})
    ok = (rec_["objective_bit_equal"]
          and all(collections.Counter(x.kernel_entries()) == x.launched
                  for x in traces.values())
          and t.kernels() == enumerated
          and {k.split("[")[0] for k in t.kernels()} == want
          and all(syncs[u.name] == rec_["syncs_found"][u.name]
                  for u in units)
          and witness["warnings"] == witness["syncs"]
          and not rec_["unbaselined"])
    if not ok:
        raise AssertionError(f"lint {impl}/{mode}: {rec_}")
    del tr, cands, traces
    torch.cuda.empty_cache()
    return rec_


def lint_child(data_dir, out_path):
    """Phase 21 in a fresh process on card 0 (beside 17, 19 and 20): the
    recorded-step lint of the GCN 602-256-41 at Reddit's shape from phase
    5's weights (:func:`_lint_run` for each of :data:`LINT_RUNS`).  Writes
    the record and the counts."""
    import torch
    from roc_tpu_torch.analysis.findings import load_baseline
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    baseline = load_baseline(os.path.join(
        here, "roc_tpu_torch", "analysis", "lint_baseline.json"))
    counts = Launches(torch)
    ds = _map_dataset(data_dir, LAYERS[-1])
    params = _gcn_params(torch)
    # the recorder's first use in a process, outside the timings
    from roc_tpu_torch.analysis.step_trace import record
    record(lambda: torch.ones(1, device="cuda") + 1)
    rec = {"runs": []}
    for impl, mode in LINT_RUNS:
        r = _lint_run(torch, ds, params, impl, mode, counts, baseline)
        rec["runs"].append(r)
        log({"phase": "lint", **r, "card": card_line()})
    rec["seconds"] = time.perf_counter() - t_start
    with open(out_path, "w") as f:
        json.dump({"record": rec, "counted": counts.counted}, f)


def start_lint_child(tmp):
    """:func:`lint_child` pre-started on the Reddit shape under
    ``tmp``/reddit, writing ``tmp``/lint.json."""
    data = os.path.join(tmp, "reddit")
    out = os.path.join(tmp, "lint.json")
    return _Child(f"lint_child({data!r}, {out!r})", 600, "phase 21 (lint)")


def save_fleet_params(tmp, akx_params, gcn_params):
    """Phase 13's trained SGC weights and phase 4's GCN weights saved for
    :func:`fleet_child` under ``tmp``."""
    import torch
    torch.save({"akx": {k: v.detach().cpu() for k, v in akx_params.items()},
                "gcn": {k: v.detach().cpu() for k, v in gcn_params.items()}},
               os.path.join(tmp, "fleet_params.pt"))


def start_fleet_child(tmp):
    """:func:`fleet_child` pre-started on the Reddit shape under
    ``tmp``/reddit and the weights :func:`save_fleet_params` wrote."""
    data = os.path.join(tmp, "reddit")
    params = os.path.join(tmp, "fleet_params.pt")
    out = os.path.join(tmp, "fleet.json")
    return _Child(f"fleet_child({data!r}, {params!r}, {out!r})", 600,
                  "phase 18 (fleet)")


def run_fleet_child(tmp, akx_params=None, gcn_params=None, pre=None):
    """:func:`fleet_child` in a fresh Python process on the Reddit-shape
    dataset under ``tmp``/reddit, with phase 13's trained SGC weights and
    phase 4's GCN weights (saved now when given); returns what it
    wrote."""
    if akx_params is not None:
        save_fleet_params(tmp, akx_params, gcn_params)
    (pre or start_fleet_child(tmp)).run()
    with open(os.path.join(tmp, "fleet.json")) as f:
        return json.load(f)


def start_memory_child(tmp, num_classes):
    """:func:`memory_child` pre-started on the datasets under ``tmp``."""
    data, prod = os.path.join(tmp, "reddit"), os.path.join(tmp, "products")
    out = os.path.join(tmp, "memory.json")
    return _Child(f"memory_child({data!r}, {prod!r}, {num_classes}, "
                  f"{out!r})", 600, "phase 15 (memory)")


def run_memory_child(tmp, num_classes, pre=None):
    """:func:`memory_child` in a fresh Python process on the datasets
    under ``tmp`` (:func:`prep_datasets`); returns what it wrote."""
    (pre or start_memory_child(tmp, num_classes)).run()
    with open(os.path.join(tmp, "memory.json")) as f:
        return json.load(f)


# every child process started ahead of its turn, ended by main() on its
# way out whatever happened
_STARTED = []


def _ready(go):
    """A pre-started child's set-up (torch, a CUDA context on card 0, the
    kernels' library, the port's heavy modules), then its wait for the
    file ``go``; it exits if its parent ended first.  ``t_s`` counts from
    the go."""
    global _T0
    parent = os.getppid()
    import torch
    from roc_tpu_torch.kernels import _build
    torch.cuda.set_device(0)
    torch.empty(1, device="cuda").sum().item()
    _build.library()
    import roc_tpu_torch.parallel.distributed  # noqa: F401
    import roc_tpu_torch.serve.export  # noqa: F401
    import roc_tpu_torch.train.trainer  # noqa: F401
    while not os.path.exists(go):
        if os.getppid() != parent:
            sys.exit(1)
        time.sleep(0.05)
    _T0 = time.perf_counter()


class _Child:
    """``python -c "import chip_smoke as s; s.<call>"`` in a fresh process
    on this card, started ahead of its turn: it sets up (:func:`_ready`)
    and waits for :meth:`run`, which releases it and waits for its end,
    so a process's start (~8 s on the card's host) overlaps the phase
    before.  Its output goes to this process's, or with ``capture`` to
    ``stdout`` and ``stderr``."""

    def __init__(self, call, timeout, what, capture=False, env=None):
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ if env is None else env)
        env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
        self.go = os.path.join(tempfile.gettempdir(), f"chip_smoke_go_"
                               f"{os.getpid()}_{len(_STARTED)}")
        pipe = subprocess.PIPE if capture else None
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke as s; s._ready({self.go!r}); s.{call}"],
            cwd=here, env=env, stdout=pipe, stderr=pipe, text=True)
        self.timeout, self.what = timeout, what
        self.stdout = self.stderr = None
        _STARTED.append(self)

    def release(self):
        """Let the child run (its ``timeout`` counts from here)."""
        with open(self.go, "w"):
            pass
        self.t_go = time.perf_counter()

    def wait(self, check=True):
        """Wait for the released child's end; raises if ``check`` and it
        failed, or if it outlived its ``timeout``.  Returns its exit
        code."""
        left = self.timeout - (time.perf_counter() - self.t_go)
        try:
            self.stdout, self.stderr = self.proc.communicate(
                timeout=max(left, 1.0))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            raise AssertionError(f"{self.what} still ran after "
                                 f"{self.timeout} s")
        finally:
            if os.path.exists(self.go):
                os.unlink(self.go)
        if check and self.proc.returncode != 0:
            raise AssertionError(f"{self.what} failed: exit "
                                 f"{self.proc.returncode}")
        return self.proc.returncode

    def run(self, check=True):
        """:meth:`release`, then :meth:`wait`."""
        self.release()
        return self.wait(check)


def _run_together(children, alongside=None):
    """Phases that share the card at once: release every child, run
    ``alongside()`` in this process, then wait for all of them, raising
    as soon as one fails.  With ``--deep`` (timed work wanted) one after
    another instead.  Returns what ``alongside`` returned."""
    if DEEP:
        got = alongside() if alongside is not None else None
        for c in children:
            c.run()
        return got
    for c in children:
        c.release()
    got = alongside() if alongside is not None else None
    pending = list(children)
    while pending:
        for c in list(pending):
            if c.proc.poll() is not None or \
                    time.perf_counter() - c.t_go > c.timeout:
                c.wait()
                pending.remove(c)
        time.sleep(0.2)
    return got


def _end_started():
    """Kill every started child still running (an early exit)."""
    for c in _STARTED:
        if c.proc.poll() is None:
            c.proc.kill()
            c.proc.wait()
        if os.path.exists(c.go):
            os.unlink(c.go)


def _child(here, call, timeout, what):
    """:class:`_Child` started and run at once; raises if it failed."""
    _Child(call, timeout, what).run()


def reddit_dataset():
    """Reddit's shape from SEED: V = 232,965, average degree ~493, the
    602-256-41 GCN's widths."""
    from roc_tpu_torch.core.graph import synthetic_dataset
    return synthetic_dataset(num_nodes=V, avg_degree=AVG_DEGREE,
                             in_dim=LAYERS[0], num_classes=LAYERS[-1],
                             seed=SEED, name="reddit_shape")


def prep_datasets(root):
    """The Reddit and products shapes built on the host and saved as .npy
    under ``root``/reddit and ``root``/products, each directory's
    ``done.json`` (build and save seconds) written last.  main() runs
    it in a process of its own beside the card's set-up and first
    phases; every later phase maps these files."""
    for name, make in (("reddit", reddit_dataset),
                       ("products", products_dataset)):
        path = os.path.join(root, name)
        os.makedirs(path)
        t0 = time.perf_counter()
        ds = make()
        info = {"dataset_s": time.perf_counter() - t0}
        t0 = time.perf_counter()
        _save_dataset(ds, path)
        info["save_s"] = time.perf_counter() - t0
        del ds
        with open(os.path.join(path, "done.tmp"), "w") as f:
            json.dump(info, f)
        os.replace(os.path.join(path, "done.tmp"),
                   os.path.join(path, "done.json"))


def _await_prep(prep, path, timeout=900):
    """:func:`prep_datasets`'s record of ``path`` once written, with the
    seconds waited (``wait_s``); raises if the prep process ended
    without it."""
    done = os.path.join(path, "done.json")
    t0 = time.perf_counter()
    while not os.path.exists(done):
        if prep.poll() is not None and not os.path.exists(done):
            raise AssertionError(f"the dataset prep exited "
                                 f"{prep.returncode} before {path}")
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"no dataset at {path} after {timeout} s")
        time.sleep(0.05)
    with open(done) as f:
        return {**json.load(f), "wait_s": time.perf_counter() - t0}


def start_layouts_child(tmp, num_classes):
    """:func:`layouts_child` pre-started (:class:`_Child`) on the datasets
    :func:`prep_datasets` wrote under ``tmp``."""
    data, prod = os.path.join(tmp, "reddit"), os.path.join(tmp, "products")
    out = os.path.join(tmp, "layouts.json")
    return _Child(f"layouts_child({data!r}, {num_classes}, {out!r}, "
                  f"{prod!r})", 900, "phase 14 (layouts)")


def run_layouts_child(tmp, num_classes, pre=None):
    """:func:`layouts_child` in a fresh Python process (``pre``, else one
    started now) on the datasets under ``tmp``; returns what it wrote."""
    (pre or start_layouts_child(tmp, num_classes)).run()
    with open(os.path.join(tmp, "layouts.json")) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# 19. The chunked edge-list routes ('blocked', 'scan'), the chunked head,
# the CLI's compute flags (--resume, --eval-only, --save-logits under
# --reorder) and the checkpointed ELL max, in a fresh process on the
# prep's datasets; and, behind --attention-race, the race that
# gives the card row its attention entry
# ---------------------------------------------------------------------------

ROUTE_STEPS = 2
# 'blocked' and 'scan' against 'cuda' (fp32 sums in other orders over two
# steps); the chunked head against the whole one (the head's rows in other
# cuBLAS tilings, its weight gradient summed by blocks)
ROUTE_RTOL = 1e-4
HEAD_RTOL = 1e-5
HEAD_CHUNK = 65_536
# the CLI's file set: the GCN's widths on a small synthetic graph
CLI_V, CLI_DEGREE, CLI_EPOCHS = 16_384, 24, 3
CLI_RTOL = 1e-4
SAGE_POOL = ("sage", {"aggregator": "pool"})


def _route_run(torch, ds, impl, params, counts, **cfg):
    """``ROUTE_STEPS`` steps of the GCN (dropout 0, fp32) on ``impl`` from
    ``params``, counted (the counts zeroed just before the trainer is
    built and read just after the steps): the objectives, the set-up
    seconds, the first and the steady step's ms, and the card's peak
    bytes over the run (tables, features and the steps)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    counts.zero()
    t0 = time.perf_counter()
    tr = _trainer(ds, impl, 0.0, params=params, eval_every=10 ** 6,
                  verbose=False, **cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    steps = []
    for _ in range(ROUTE_STEPS):
        t1 = time.perf_counter()
        tr.train(1)
        tr.sync()
        steps.append((time.perf_counter() - t1) * 1e3)
    launches = counts.read(F32)
    rec = {"route": tr.config.aggr_impl, "head_chunk": tr.gctx.head_chunk,
           "losses": torch.stack(tr.losses).double().cpu().tolist(),
           "setup_s": setup_s, "step_ms": steps,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches}
    del tr
    torch.cuda.empty_cache()
    return rec


def _rel_err(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return float((np.abs(got - ref) / np.abs(ref)).max())


def edge_routes(torch, ds, params, counts):
    """The GCN at Reddit's shape on 'cuda' (the yardstick, head_chunk 0),
    'blocked' and 'scan': objectives within ROUTE_RTOL of 'cuda''s, no
    kernel launched by the plain routes; then 'auto' with head_chunk
    65536, which resolves to 'cuda' and runs K1, K2 and K4, within
    HEAD_RTOL of head_chunk 0."""
    out = {"cuda": _route_run(torch, ds, "cuda", params, counts,
                              head_chunk=0)}
    ref = out["cuda"]["losses"]
    if not all(out["cuda"]["launches"][k][F32] for k in (
            "indegree_norm", "scale_act", "ell_aggregate")):
        raise AssertionError(f"cuda: launches {out['cuda']['launches']}")
    for impl in ("blocked", "scan"):
        rec = out[impl] = _route_run(torch, ds, impl, params, counts)
        rec["max_rel_err"] = _rel_err(rec["losses"], ref)
        if any(by[F32] for k, by in rec["launches"].items()
               if isinstance(by, dict)) or rec["route"] != impl:
            raise AssertionError(f"{impl}: {rec['route']}, launches "
                                 f"{rec['launches']}")
        if not (np.isfinite(rec["losses"]).all()
                and rec["max_rel_err"] <= ROUTE_RTOL):
            raise AssertionError(f"{impl}: losses {rec['losses']} against "
                                 f"cuda's {ref}")
        log({"phase": "routes_edge", "impl": impl, **rec})
    rec = out["head_chunk"] = _route_run(torch, ds, "auto", params, counts,
                                         head_chunk=HEAD_CHUNK)
    rec["max_rel_err"] = _rel_err(rec["losses"], ref)
    if rec["route"] != "cuda" or rec["head_chunk"] != HEAD_CHUNK or not (
            rec["max_rel_err"] <= HEAD_RTOL) or not all(
            rec["launches"][k][F32] for k in (
                "indegree_norm", "scale_act", "ell_aggregate")) or not \
            rec["launches"]["indegree_norm_masked"]:
        raise AssertionError(f"head_chunk: {rec} against cuda's {ref}")
    log({"phase": "routes_head_chunk", **rec})
    log({"phase": "routes_cuda", **out["cuda"]})
    return out


def cli_flags(torch, tmp, counts):
    """The CLI at the GCN's widths on a file set in the reference's
    format: 3 epochs with --checkpoint and the telemetry flags (--events,
    --metrics, --profile-dir, an eval every epoch), the report on their
    files (exit 0, the first-step, span and throughput rows), the same 3
    epochs with --events alone (``epoch_ms`` beside the first run's, not
    gated), then --resume --eval-only --save-logits under --reorder bfs;
    each run counted; the saved logits, in the original order, against
    ``Trainer.predict`` of the unreordered graph restored from the
    checkpoint (CLI_RTOL of the logit scale)."""
    import io
    from roc_tpu_torch.core.graph import (load_dataset, save_dataset,
                                          synthetic_dataset)
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.train import cli
    from roc_tpu_torch.train.trainer import TrainConfig, Trainer
    from roc_tpu_torch.utils.checkpoint import restore_trainer
    root = os.path.join(tmp, "cli")
    os.makedirs(root)
    prefix, ck = os.path.join(root, "g"), os.path.join(root, "ck")
    npy = os.path.join(root, "logits.npy")
    save_dataset(synthetic_dataset(CLI_V, CLI_DEGREE, in_dim=LAYERS[0],
                                   num_classes=LAYERS[-1], seed=SEED),
                 prefix, csv=False)
    base = ["-file", prefix, "-layers", "-".join(map(str, LAYERS)),
            "-dropout", "0", "-e", str(CLI_EPOCHS)]
    tele = {k: os.path.join(root, k) for k in ("events.jsonl",
                                               "metrics.jsonl", "prof")}
    ev_off = os.path.join(root, "events_off.jsonl")
    from roc_tpu_torch.obs import events
    counts.zero()
    t0 = time.perf_counter()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc1 = cli.main(base + [
                "--checkpoint", ck, "--eval-every", "1", "--events",
                tele["events.jsonl"], "--metrics", tele["metrics.jsonl"],
                "--profile-dir", tele["prof"]])
        train_s = time.perf_counter() - t0
        train_launches = counts.read(F32)
        counts.zero()
        with contextlib.redirect_stdout(io.StringIO()):
            rc_off = cli.main(base + ["--eval-every", "1", "--events",
                                      ev_off])
        off_launches = counts.read(F32)
    finally:
        events.configure()
    rc_report, text = _report(tele)
    ms_on = [r["epoch_ms"] for r in map(json.loads, open(
        tele["metrics.jsonl"]))]
    ms_off = [r["epoch_ms"] for r in map(json.loads, open(ev_off))
              if r["cat"] == "epoch" and "train_loss" in r]
    _, kernels, _ = _trace_names(tele["prof"])
    if (rc1, rc_off, rc_report) != (0, 0, 0) or "train_step" not in \
            _report_rows(text, "first step (per step slot)") or not {
            "train", "eval"} <= set(_report_rows(text, "phase spans (ms)")) \
            or "tflops_per_s" not in _report_rows(text, "throughput") or \
            not kernels.get("ell_bucket_sum"):
        raise AssertionError(f"cli telemetry: exits {rc1}, {rc_off}, "
                             f"report {rc_report}, trace kernels "
                             f"{kernels}:\n{text}")
    counts.zero()
    t0 = time.perf_counter()
    buf2 = io.StringIO()
    with contextlib.redirect_stdout(buf2):
        rc2 = cli.main(base + ["--resume", ck, "--eval-only",
                               "--save-logits", npy, "--reorder", "bfs"])
    eval_s = time.perf_counter() - t0
    launches = counts.read(F32)
    if (rc1, rc2) != (0, 0):
        raise AssertionError(f"cli exits {rc1}, {rc2}")
    got = np.load(npy)
    ds = load_dataset(prefix, LAYERS[0], LAYERS[-1])
    tr = Trainer(build_gcn(LAYERS, dropout_rate=0.0), ds,
                 TrainConfig(aggr_impl="auto", verbose=False, **TRAIN))
    restore_trainer(tr, ck)
    want = tr.predict().float().cpu().numpy()
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    lines = buf2.getvalue().splitlines()
    rec = {"V": ds.graph.num_nodes, "E": ds.graph.num_edges,
           "shape": list(got.shape), "dtype": str(got.dtype),
           "max_abs_err": err, "logit_scale": scale,
           "train_s": train_s, "eval_only_s": eval_s, "infer": lines,
           "epoch": tr.epoch, "launches": launches,
           "train_launches": train_launches, "off_launches": off_launches,
           "telemetry_epoch_ms": {"on": ms_on, "off": ms_off},
           "trace_device_kernels": kernels}
    del tr
    torch.cuda.empty_cache()
    if got.shape != want.shape or got.dtype != np.float32 or not (
            err <= CLI_RTOL * max(scale, 1.0)) or len(lines) != 1 or \
            not lines[0].startswith(f"[INFER][{CLI_EPOCHS}]"):
        raise AssertionError(f"cli: {rec}")
    if not all(launches[k][F32] for k in ("indegree_norm", "scale_act",
                                          "ell_aggregate")):
        raise AssertionError(f"cli --eval-only: launches {launches}")
    log({"phase": "routes_cli", **rec})
    return rec


def ell_max_products(torch, products_dir):
    """SAGE-pool 100-256-47 at the products shape on 'ell' (the
    checkpointed ELL max), ROUTE_STEPS steps in 'mixed' from the seed's
    weights, dropout 0: finite objectives, the card's peak."""
    ds = _map_dataset(products_dir, PRODUCTS_LAYERS[-1],
                      name="products_shape")
    make = functools.partial(_layout_trainer, fam=SAGE_POOL,
                             layers=PRODUCTS_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = make(ds, "ell", 0.0, mode="mixed", eval_every=10 ** 6,
              verbose=False)
    setup_s = time.perf_counter() - t0
    steps = []
    for _ in range(ROUTE_STEPS):
        t1 = time.perf_counter()
        tr.train(1)
        tr.sync()
        steps.append((time.perf_counter() - t1) * 1e3)
    losses = torch.stack(tr.losses).double().cpu().numpy()
    rec = {"route": tr.config.aggr_impl, "mode": "mixed",
           "V": ds.graph.num_nodes, "E": ds.graph.num_edges,
           "losses": losses.tolist(), "setup_s": setup_s, "step_ms": steps,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del tr
    torch.cuda.empty_cache()
    if rec["route"] != "ell" or not np.isfinite(losses).all():
        raise AssertionError(f"sage_pool ell: {rec}")
    log({"phase": "routes_ell_max", **rec})
    return rec


# the telemetry phase: epochs a run, the eval cadence, and how far the
# first-step observer's FLOP count may lie from gcn_step_flops
TELEMETRY_EPOCHS, TELEMETRY_EVAL_EVERY = 6, 5
TELEMETRY_FLOPS_RTOL = 0.10
TELEMETRY_MODES = (("float32", F32), ("mixed", BF16))


def gcn_step_flops(V, E, layers=LAYERS):
    """The analytic work of one training step of the fused GCN on 'cuda':
    ``(matmul FLOPs, kernel operations)``.  The matmuls are every layer's
    forward and weight gradient and every input gradient but the first
    layer's (the features take none), 2·M·N·K each; a fused aggregation
    runs K1, K4 and K2 once forward and once backward at its width
    (kernels/_build.py ``kernel_ops``)."""
    from roc_tpu_torch.kernels._build import kernel_ops
    mm = [2 * V * a * b for a, b in zip(layers, layers[1:])]
    kern = sum(2 * sum(kernel_ops(k, V, E, F) for k in (
        "indegree_norm", "ell_aggregate", "scale_act"))
        for F in layers[1:])
    return 3 * sum(mm) - mm[0], kern


def _telemetry_run(torch, ds, params, counts, root, mode, key, on,
                   profile):
    """``TELEMETRY_EPOCHS`` epochs of the GCN on 'cuda' in ``mode`` from
    ``params``, dropout 0.5, an eval every ``TELEMETRY_EVAL_EVERY``,
    counted (the counts zeroed just before the loop, read just after).
    ``on``: through ``Trainer.train`` with its events in a JSONL under
    ``root``, ``metrics_path`` and (``profile``) ``profile_dir``; off:
    the same loop over the bare step slots (no first-step observer), no
    file.  The card's peak is reset before the trainer is built."""
    from roc_tpu_torch.obs import events
    from roc_tpu_torch.train.trainer import run_epoch_loop
    tag = f"{mode}_{'on' if on else 'off'}"
    paths = {k: os.path.join(root, f"{tag}_{k}") for k in (
        "events.jsonl", "metrics.jsonl", "prof")}
    cfg = dict(epochs=TELEMETRY_EPOCHS, eval_every=TELEMETRY_EVAL_EVERY,
               verbose=False)
    if on:
        cfg["metrics_path"] = paths["metrics.jsonl"]
        if profile:
            cfg["profile_dir"] = paths["prof"]
    sink = events.JsonlSink(paths["events.jsonl"]) if on else None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bus = events.get_bus()
    if sink is not None:
        bus.add_sink(sink)
    try:
        tr = _trainer(ds, "cuda", 0.5, params=params, mode=mode, **cfg)
        counts.zero()
        t0 = time.perf_counter()
        hist = (tr.train() if on else
                run_epoch_loop(tr, None, tr.step, tr.evaluate))
        tr.sync()
        wall_s = time.perf_counter() - t0
        launches = counts.read(key)
        ops = sum(k.ops for k in counts.kernels)
    finally:
        if sink is not None:
            bus.sinks.remove(sink)
            sink.close()
    rec = {"mode": mode, "on": on, "wall_s": wall_s,
           "epoch_ms": [m["epoch_ms"] for m in hist],
           "losses": torch.stack(tr.losses).double().cpu().tolist(),
           "launches": launches, "kernel_ops": ops,
           "buckets": len(tr.gctx.ell_idx),
           "bucket_edges": sum(tr.gctx.ell_edges),
           "modeled_bytes": tr.modeled_bytes, "hist": hist,
           "paths": paths}
    if on:
        rec["events"] = [json.loads(ln) for ln in open(paths[
            "events.jsonl"])]
        rec["metrics"] = [json.loads(ln) for ln in open(paths[
            "metrics.jsonl"])]
    del tr
    torch.cuda.empty_cache()
    return rec


def _report(paths):
    """``python -m roc_tpu_torch.report`` on a run's event and metrics
    files: its exit code and output."""
    here = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run(
        [sys.executable, "-m", "roc_tpu_torch.report",
         paths["events.jsonl"], "--metrics", paths["metrics.jsonl"]],
        cwd=here, capture_output=True, text=True, timeout=120)
    return r.returncode, r.stdout + r.stderr[-2000:]


def _report_rows(out, title):
    """The first words of the rows of a report's table ``title``."""
    body = out.split(f"== {title} ==\n", 1)[1].split("\n\n")[0]
    return [ln.split()[0] for ln in body.splitlines()[1:] if ln.strip()]


def _trace_names(prof_dir):
    """The event names of the one Chrome trace under ``prof_dir``, and
    the device kernels' names by count."""
    import glob
    (path,) = glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    kernels = {}
    for e in evs:
        if e.get("cat") == "kernel":
            name = e.get("name", "")
            for k in ("ell_bucket_sum", "row_scale_kernel", "csr_row_sum"):
                if k in name:
                    kernels[k] = kernels.get(k, 0) + 1
    return {e.get("name") for e in evs}, kernels, os.path.getsize(path)


def telemetry(torch, ds, params, counts, root):
    """The trainer's run telemetry on the card: the GCN 602-256-41 at
    Reddit's shape from phase 5's weights, fp32 and 'mixed', with
    telemetry on (events, metrics, the profiler on fp32) and off; checks
    the manifest, the first step's ``compile`` event (the kernels' FLOPs
    equal to the wrappers' launches at their shapes, the whole within
    ``TELEMETRY_FLOPS_RTOL`` of :func:`gcn_step_flops`, no degrade), each
    eval record's fields (``mfu`` in (0, 1]), the objectives of every step
    bit-equal on and off, the trace's ranges and kernels, and the report
    on the run's files."""
    kind = torch.cuda.get_device_name(0)
    g = ds.graph
    V, E = g.num_nodes, g.num_edges
    mm, kern = gcn_step_flops(V, E)
    kern_eval = kern // 2
    out = {"analytic_step_flops": mm + kern, "analytic_matmul_flops": mm,
           "analytic_kernel_ops": kern}
    t0 = time.perf_counter()
    with shared_contexts():
        for mode, key in TELEMETRY_MODES:
            on = _telemetry_run(torch, ds, params, counts, root, mode, key,
                                True, mode == "float32")
            off = _telemetry_run(torch, ds, params, counts, root, mode,
                                 key, False, False)
            evs = on.pop("events")
            (man,) = [e for e in evs if e["cat"] == "manifest"]
            firsts = {e["name"]: e for e in evs if e["cat"] == "compile"
                      and "first_step_s" in e}
            degraded = [e for e in evs if e.get("degraded")]
            c, ce = firsts["train_step"], firsts["eval_step"]
            nb = on["buckets"]
            steps, evals = TELEMETRY_EPOCHS, (
                TELEMETRY_EPOCHS // TELEMETRY_EVAL_EVERY)
            want_launches = {
                "indegree_norm": 4 * steps + 2 * evals,
                "scale_act": 4 * steps + 2 * evals,
                "ell_aggregate": (4 * steps + 2 * evals) * nb,
                "indegree_norm_masked": steps}
            got_launches = {k: (on["launches"][k][key]
                                if isinstance(on["launches"][k], dict)
                                else on["launches"][k])
                            for k in want_launches}
            (m,) = on["hist"]
            rel = abs(c["flops"] - (mm + kern)) / (mm + kern)
            rec = {
                "mode": mode, "device_kinds": man["device_kinds"],
                "manifest_resolved": man["resolved"],
                "modeled_step_bytes": man.get("modeled_step_bytes"),
                "first_step_s": c["first_step_s"], "flops": c["flops"],
                "flops_counted": c["flops_counted"],
                "flops_kernels": c["flops_kernels"],
                "flops_rel_err": rel, "eval_flops": ce["flops"],
                "peak_bytes": c["peak_bytes"],
                "modeled_bytes": c["modeled_bytes"],
                "model_actual_ratio": c.get("model_actual_ratio"),
                "model_delta_bytes": c.get("model_delta_bytes"),
                "launches": got_launches, "kernel_ops": on["kernel_ops"],
                "record": {k: m.get(k) for k in (
                    "epoch_ms", "first_step_ms", "eval_ms", "edges_per_s",
                    "tflops_per_s", "mfu", "step_ewma_ms")},
                "metrics_records": len(on["metrics"]),
                "epoch_ms_on": on["epoch_ms"], "epoch_ms_off": off[
                    "epoch_ms"], "wall_s_on": on["wall_s"],
                "wall_s_off": off["wall_s"],
                "bit_equal": on["losses"] == off["losses"]}
            if man["platform"] != "gpu" or not any(
                    "H100" in k for k in man["device_kinds"]) or \
                    man["resolved"]["aggr_impl"] != "cuda" or \
                    man.get("modeled_step_bytes") != on["modeled_bytes"]:
                raise AssertionError(f"telemetry {mode}: manifest {man}")
            if degraded or set(firsts) != {"train_step", "eval_step"}:
                raise AssertionError(f"telemetry {mode}: first-step events "
                                     f"{firsts}, degraded {degraded}")
            if on["bucket_edges"] != E or got_launches != want_launches or \
                    c["flops_kernels"] != kern or \
                    ce["flops_kernels"] != kern_eval or \
                    on["kernel_ops"] != steps * kern + evals * kern_eval:
                raise AssertionError(
                    f"telemetry {mode}: kernel work {rec}: want launches "
                    f"{want_launches}, step ops {kern}, eval ops "
                    f"{kern_eval}")
            if not rel <= TELEMETRY_FLOPS_RTOL or not (
                    c["peak_bytes"] and c["peak_bytes"] > 0) or \
                    c.get("model_actual_ratio") is None:
                raise AssertionError(f"telemetry {mode}: {rec}")
            if not all(isinstance(m.get(k), (int, float)) and m[k] > 0
                       for k in ("epoch_ms", "first_step_ms",
                                 "edges_per_s", "tflops_per_s",
                                 "step_ewma_ms")) or not (
                    0 < m.get("mfu", 0) <= 1) or \
                    len(on["metrics"]) != evals or \
                    not set(on["metrics"][0]) >= set(m):
                raise AssertionError(f"telemetry {mode}: record {m}, "
                                     f"metrics {on['metrics']}")
            if not rec["bit_equal"]:
                raise AssertionError(
                    f"telemetry {mode}: objectives on {on['losses']} and "
                    f"off {off['losses']} differ")
            if mode == "float32":
                names, kernels, size = _trace_names(on["paths"]["prof"])
                want = {"roc_indegree_norm", "roc_scale_act",
                        "roc_ell_aggregate", "first_step", "train", "eval"}
                rec["trace"] = {"bytes": size, "device_kernels": kernels,
                                "missing": sorted(want - names)}
                if want - names or not kernels.get("ell_bucket_sum") or \
                        not kernels.get("row_scale_kernel"):
                    raise AssertionError(f"telemetry trace: {rec['trace']}")
            rc, text = _report(on["paths"])
            rec["report_rc"] = rc
            if rc != 0 or "train_step" not in _report_rows(
                    text, "first step (per step slot)") or not {
                    "first_step", "train", "eval"} <= set(_report_rows(
                        text, "phase spans (ms)")) or not {
                    "edges_per_s", "tflops_per_s", "mfu"} <= set(
                        _report_rows(text, "throughput")):
                raise AssertionError(f"telemetry {mode}: report exit {rc}:"
                                     f"\n{text}")
            log({"phase": "routes_telemetry", **rec})
            out[mode] = rec
    out["seconds"] = time.perf_counter() - t0
    out["card"] = kind
    return out


# the plain sentinel script run with torch blocked from import
_NO_TORCH = ("import sys, runpy; sys.modules['torch'] = None; "
             "sys.argv = sys.argv[1:]; "
             "runpy.run_path(sys.argv[0], run_name='__main__')")


def _sentinel_cli(argv, plain=False):
    """``python -m roc_tpu_torch.sentinel --json argv`` (``plain``: the
    module as a plain script, torch blocked): its exit code and
    payload."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = ([sys.executable, "-c", _NO_TORCH,
            os.path.join(here, "roc_tpu_torch", "obs", "sentinel.py")]
           if plain else [sys.executable, "-m", "roc_tpu_torch.sentinel"])
    r = subprocess.run(cmd + ["--json"] + argv, cwd=here,
                       capture_output=True, text=True, timeout=60)
    lines = r.stdout.strip().splitlines()
    if r.returncode not in (0, 1) or not lines:
        raise AssertionError(f"sentinel {argv} (plain={plain}): exit "
                             f"{r.returncode}\n{r.stdout}{r.stderr[-2000:]}")
    return r.returncode, json.loads(lines[-1])


def sentinel_check(telem, root):
    """Phase 22: the regression sentinel over :func:`telemetry`'s runs
    (their files under ``root``).  Per dtype mode, a round in the bench
    headline shape at the telemetry-off steady ``epoch_ms`` (history
    ``ok``), and one at half of it in a second directory (history
    ``regress``: the on-run is then a 2x regression by construction);
    the sentinel CLI on the on-run's metrics file against each, as
    ``-m`` and as the plain script with torch blocked, and
    ``bench_verdict`` in process.  Raises on any gate."""
    from roc_tpu_torch.obs import sentinel as sen
    t0 = time.perf_counter()
    dirs = {h: os.path.join(root, f"sentinel_{h}") for h in ("ok",
                                                             "regress")}
    for i, (mode, _) in enumerate(TELEMETRY_MODES):
        off_ms = float(np.median(telem[mode]["epoch_ms_off"]))
        for h, d in dirs.items():
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"BENCH_torch_r{i + 1:02d}_{mode}"
                                      f".json"), "w") as f:
                json.dump({"metric": "epoch_ms",
                           "value": off_ms if h == "ok" else off_ms / 2,
                           "unit": "ms", "dtype": mode, "stage": "full"}, f)
    out = {}
    for mode, _ in TELEMETRY_MODES:
        metrics = os.path.join(root, f"{mode}_on_metrics.jsonl")
        with open(metrics) as f:
            (m,) = [json.loads(ln) for ln in f if ln.strip()]
        if m["epoch_ms"] != telem[mode]["record"]["epoch_ms"]:
            raise AssertionError(f"sentinel {mode}: the metrics file's "
                                 f"record {m} is not the run's "
                                 f"{telem[mode]['record']}")
        want = {"step_ms": round(m["epoch_ms"], 3),
                "compile_s": round(m["first_step_ms"] / 1e3, 3)}
        rec = {"record": {k: m[k] for k in ("epoch_ms", "first_step_ms")},
               "off_epoch_ms": float(np.median(
                   telem[mode]["epoch_ms_off"]))}
        for h, d in dirs.items():
            argv = ["--metrics", metrics, "--dtype", mode, "--bench-glob",
                    os.path.join(d, sen.BENCH_GLOB)]
            rc, pay = _sentinel_cli(argv)
            rc_plain, pay_plain = _sentinel_cli(argv, plain=True)
            step = pay["checks"]["step_time_ms"]
            rec[h] = {"exit": rc, "regressed": pay["regressed"],
                      "current": {k: pay["current"][k] for k in want},
                      **{k: step.get(k) for k in (
                          "verdict", "median", "bound", "n", "rule")},
                      "rounds": pay["history_rounds"],
                      "plain_equal": rc_plain == rc and pay_plain == pay}
            good = (rc == 0 and not pay["regressed"]
                    and step["verdict"] == "ok") if h == "ok" else (
                rc == 1 and pay["regressed"] == ["step_time_ms"])
            if not good or step.get("n") != 1 or \
                    step.get("rule") != "small_sample_1.5x" or \
                    len(pay["history_rounds"]) != len(TELEMETRY_MODES) or \
                    rec[h]["current"] != want or not rec[h]["plain_equal"]:
                raise AssertionError(f"sentinel {mode}/{h}: want "
                                     f"{want}, {rec}\n{pay}")
        rec["bench_verdict"] = sen.bench_verdict(
            m["epoch_ms"], dtype=mode, bench_dir=dirs["ok"], stage="full")
        if rec["bench_verdict"].get("verdict") != "ok" or \
                rec["bench_verdict"].get("n_history") != 1:
            raise AssertionError(f"sentinel {mode}: bench_verdict "
                                 f"{rec['bench_verdict']}")
        out[mode] = rec
    out["seconds"] = time.perf_counter() - t0
    log({"phase": "sentinel", **out, "card": card_line()})
    return out


def routes_child(data_dir, products_dir, num_classes, out_path):
    """Phase 19 in a fresh process on card 0 (the datasets saved
    under ``data_dir`` and ``products_dir``): :func:`edge_routes`,
    :func:`telemetry` and phase 22's :func:`sentinel_check` on its runs,
    :func:`cli_flags`, :func:`ell_max_products`; writes
    the record and the counts to ``out_path``.  This process opens no
    profiler session before the telemetry phase's trace (the profiler
    loses records after ~60 sessions in one process)."""
    import torch
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    _build.library()
    counts = Launches(torch)
    t0 = time.perf_counter()
    ds = _map_dataset(data_dir, num_classes)
    params = _gcn_params(torch)
    rec = {"edge": edge_routes(torch, ds, params, counts)}
    with tempfile.TemporaryDirectory() as tmp:
        rec["telemetry"] = telemetry(torch, ds, params, counts, tmp)
        rec["sentinel"] = sentinel_check(rec["telemetry"], tmp)
    del ds
    with tempfile.TemporaryDirectory() as tmp:
        rec["cli"] = cli_flags(torch, tmp, counts)
    rec["ell_max"] = ell_max_products(torch, products_dir)
    rec["seconds"] = time.perf_counter() - t0
    with open(out_path, "w") as f:
        json.dump({"record": rec, "counted": counts.counted}, f)


def start_routes_child(tmp, num_classes):
    """:func:`routes_child` pre-started on the datasets under ``tmp``."""
    data, prod = os.path.join(tmp, "reddit"), os.path.join(tmp, "products")
    out = os.path.join(tmp, "routes.json")
    return _Child(f"routes_child({data!r}, {prod!r}, {num_classes}, "
                  f"{out!r})", 600, "phase 19 (routes)")


def run_routes_child(tmp, num_classes, pre=None):
    """:func:`routes_child` in a fresh Python process on the datasets
    under ``tmp``; returns what it wrote."""
    (pre or start_routes_child(tmp, num_classes)).run()
    with open(os.path.join(tmp, "routes.json")) as f:
        return json.load(f)


# the attention race: routes and modes, steps a run
ATTN_RACE_ROUTES = ("attn_flat8", "ell", "cuda")
ATTN_RACE_STEPS = 3


FIRST_GATHER_V = 4_000
FIRST_GATHER_LAYERS = [64, 8]


def first_gather(out_path=None):
    """Where a fresh sharded fleet's first gathered request goes (not in
    the default run): an SGC 64-8 (k = 2) on a 4,000-node graph exported
    with 2 shards; (a) the two shards in this process, wired ``gather_fn
    -> read_rows``, shard 0 warmed (``Predictor.warm``) and queried
    through ``Server``: each size's first and second request; (b) a
    2-replica sharded router with ``ROC_TPU_EVENTS``: each size's first
    and second request and the replicas' microbatch spans of the first
    8-row one; (c) a fresh thread's first and second staging copy
    (``index_copy_``).  Prints one JSON line, written to ``out_path``
    too."""
    import threading

    import torch
    from roc_tpu_torch.core.graph import synthetic_dataset
    from roc_tpu_torch.models.sgc import build_sgc
    from roc_tpu_torch.serve.export import (build_predictor,
                                            export_predictor,
                                            load_predictor)
    from roc_tpu_torch.serve.router import Router
    from roc_tpu_torch.serve.server import Server
    from roc_tpu_torch.train.trainer import TrainConfig
    torch.cuda.set_device(0)
    ds = synthetic_dataset(FIRST_GATHER_V, 8, in_dim=FIRST_GATHER_LAYERS[0],
                           num_classes=FIRST_GATHER_LAYERS[-1], seed=SEED)
    pred = build_predictor(build_sgc(FIRST_GATHER_LAYERS, k=2), ds,
                           TrainConfig(verbose=False, aggr_impl="segment",
                                       symmetric=True))
    out = {"card": card_line()}

    def sizes(call):
        rng = np.random.RandomState(SEED + 70)
        got = {}
        for rep in ("first", "second"):
            for n in REQUEST_SIZES:
                ids = rng.randint(0, FIRST_GATHER_V, size=n)
                ids[0] = 0
                t0 = time.perf_counter()
                rid = call(ids)
                got.setdefault(n, {})[rep] = (time.perf_counter() - t0) * 1e3
                got[n].setdefault("rids", []).append(rid)
        return got
    with tempfile.TemporaryDirectory() as root:
        art = os.path.join(root, "art")
        export_predictor(pred, art, shards=2,
                         cache_dir=os.path.join(root, "cache"))
        a = load_predictor(art, shard=0)
        b = load_predictor(art, shard=1)
        a.gather_fn = lambda ids, v: b.read_rows(ids, v)
        a.warm()
        with Server(a, max_wait_ms=0.2, name="first_gather") as srv:
            def via_server(ids):
                srv.submit(ids).result(timeout=60)
            out["in_process"] = sizes(via_server)
        ev = os.path.join(root, "ev.jsonl")
        env = dict(os.environ, ROC_TPU_EVENTS=ev,
                   PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
        with Router(art, n_replicas=2, sharded=True, env=env,
                    replica_args=FLEET_ARGS) as r:
            def via_router(ids):
                fut = r.submit(ids)
                fut.result(timeout=60)
                return fut.rid
            out["router"] = sizes(via_router)
        rid8 = out["router"][8]["rids"][0]
        spans = []
        with open(ev) as f:
            for line in f:
                e = json.loads(line)
                for name, _, ms, args in e.get("spans") or ():
                    if rid8 in (args or {}).get("rids", ()):
                        spans.append({"proc": e.get("proc"), "ms": ms})
                if e.get("kind") == "hedge" and e.get("rid") == rid8:
                    out["first_8_hedged"] = True
        out["first_8_replica_batches_ms"] = spans
        for by in (out["in_process"], out["router"]):
            for v in by.values():
                v.pop("rids")
    copies = []

    def stage():
        ms = []
        for _ in range(2):
            x = torch.from_numpy(np.random.rand(7, 64).astype(np.float32))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y = torch.zeros(8, 64, device="cuda")
            y.index_copy_(0, torch.arange(7, device="cuda"), x.cuda())
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        copies.append(ms)
    th = threading.Thread(target=stage)
    th.start()
    th.join()
    out["fresh_thread_index_copy_ms"] = copies[0]
    log({"phase": "first_gather", **out})
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f)
    return out


def attention_race(out_path=None):
    """GAT 100-256-47 (1 head) at the products shape on each of
    ATTN_RACE_ROUTES in fp32 and 'mixed', ATTN_RACE_STEPS steps each from
    the seed's weights, dropout 0: each run's steady steps' ``epoch_ms``
    and first step, objectives held to 'ell''s (LAYOUT_PLAIN_RTOL in
    'mixed', PARITY_RTOL in fp32), and the fastest route per mode.  Its
    figures are core/ell.py ``CARD_ROWS``'s attention source.  Timed
    work, so not part of the default run: ``python3 chip_smoke.py
    --attention-race``."""
    import torch
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.models import model_builders
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    _build.library()
    print(card_line(), flush=True)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    ds = products_dataset()
    log({"phase": "attn_race_data", "V": ds.graph.num_nodes,
         "E": ds.graph.num_edges, "seconds": time.perf_counter() - t0})
    gat = ("gat", {"heads": 1})
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = {k: v.detach() for k, v in model_builders()["gat"](
        PRODUCTS_LAYERS, heads=1).init_params(gen, device=dev).items()}
    make = functools.partial(_layout_trainer, fam=gat,
                             layers=PRODUCTS_LAYERS)
    out = {}
    with shared_contexts():
        for mode, rtol in (("float32", PARITY_RTOL["float32"]),
                           ("mixed", LAYOUT_PLAIN_RTOL["mixed"])):
            runs = {}
            for impl in ("ell",) + tuple(r for r in ATTN_RACE_ROUTES
                                         if r != "ell"):
                torch.cuda.reset_peak_memory_stats()
                losses, info = _layout_steps(torch, make, ds, impl, mode,
                                             params, steps=ATTN_RACE_STEPS)
                info["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                runs[impl] = (_held(losses, info, runs["ell"]["losses"],
                                    "ell", rtol) if impl != "ell"
                              else {**info, "losses": losses})
                log({"phase": "attn_race", "mode": mode, "impl": impl,
                     **{k: (v.tolist() if isinstance(v, np.ndarray) else v)
                        for k, v in runs[impl].items()}})
            runs["ell"]["losses"] = runs["ell"]["losses"].tolist()
            out[mode] = {"runs": runs, "fastest": min(
                runs, key=lambda r: runs[r]["epoch_ms"])}
    log({"phase": "attn_race_summary",
         **{m: {"fastest": r["fastest"],
                "epoch_ms": {k: v["epoch_ms"] for k, v in r["runs"].items()}}
            for m, r in out.items()}})
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f)
    print(card_line(), flush=True)
    return out


CONVERTED_SUFFIXES = (".add_self_edge.lux", ".feats.bin", ".feats.csv",
                      ".label", ".mask")


def _sha256(path, chunk=1 << 24):
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(chunk), b""):
            h.update(block)
    return h.hexdigest()


def convert_cli(dataset, out, raw_dir=None, no_csv=False, timeout=900):
    """``python -m roc_tpu_torch.convert_dataset`` in a process of its
    own, as a user runs it.  Returns its wall seconds, its peak resident
    set (GB; its ``/proc/<pid>/statm`` read every 50 ms: ``ru_maxrss``
    would carry this process's size, which a child inherits) and its
    printed lines; raises on a nonzero exit or a run past ``timeout``
    seconds."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "roc_tpu_torch.convert_dataset",
           "--dataset", dataset, "--out", out]
    cmd += ["--raw-dir", raw_dir] if raw_dir else []
    cmd += ["--no-csv"] if no_csv else []
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    page, rss = os.sysconf("SC_PAGE_SIZE"), 0
    with tempfile.TemporaryFile("w+") as log_f:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=here, env=env, stdout=log_f,
                                stderr=subprocess.STDOUT, text=True)
        statm = f"/proc/{proc.pid}/statm"
        while proc.poll() is None:
            try:
                with open(statm) as f:
                    rss = max(rss, int(f.read().split()[1]) * page)
            except (OSError, IndexError, ValueError):
                pass    # the process ended between the poll and the read
            if time.perf_counter() - t0 > timeout:
                proc.kill()
                proc.wait()
                raise AssertionError(f"{' '.join(cmd)}: still ran after "
                                     f"{timeout} s")
            time.sleep(0.05)
        wall = time.perf_counter() - t0
        log_f.seek(0)
        lines = log_f.read().splitlines()
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)}: exit {proc.returncode}:\n"
                             + "\n".join(lines[-20:]))
    return {"wall_s": wall, "rss_peak_gb": rss / 1e9, "printed": lines}


def convert_pinned(root):
    """cora-synth and karate through :func:`convert_cli` (default flags)
    under ``root``, each written file's sha256 held to
    :data:`CONVERTED_SHA256`.  Returns ``{name: (prefix, record)}``."""
    out = {}
    for name in ("cora-synth", "karate"):
        prefix = os.path.join(root, name, name)
        rec = convert_cli(name, prefix)
        got = {s: _sha256(prefix + s) for s in CONVERTED_SUFFIXES}
        rec["sha256_equal"] = got == CONVERTED_SHA256[name]
        if not rec["sha256_equal"]:
            raise AssertionError(f"{name}: the converted files' sha256 "
                                 f"{got} are not the JAX script's "
                                 f"{CONVERTED_SHA256[name]}")
        out[name] = (prefix, rec)
    return out


_ACCURACY = re.compile(r"val_accuracy: ([0-9.]+)%.*test_accuracy: "
                       r"([0-9.]+)%")


# the kernels of the GCN's path on 'cuda': K1, its masked form in the
# relu backward, K2 and K4
CUDA_ROUTE_KERNELS = ("indegree_norm", "indegree_norm_masked", "scale_act",
                      "ell_aggregate")


def cli_gate(torch, counts, prefix, flags, mode, floor, root, tag,
             gate_val=True):
    """The port's CLI (``train/cli.py main``) in this process on the card:
    ``-file prefix`` with ``flags``, ``--dtype mode`` and the event and
    metrics files, with the launch counts zeroed just before and read
    just after.  Holds: exit 0, test accuracy (and with ``gate_val`` val
    accuracy) >= ``floor`` (%) on the last ``[INFER]`` line, the
    ``resolve`` event of ``--impl auto`` naming 'cuda', the manifest's
    platform 'gpu', every kernel of :data:`CUDA_ROUTE_KERNELS` launched
    in the mode's dtype, and no plain version standing in for a kernel
    (kernels/_build.py ``instances_planned``)."""
    import io
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.obs import events
    from roc_tpu_torch.train import cli
    key = F32 if mode == "float32" else BF16
    ev, met = (os.path.join(root, f"{tag}_{mode}.{x}.jsonl")
               for x in ("events", "metrics"))
    planned = _build.instances_planned()
    buf = io.StringIO()
    counts.zero()
    t0 = time.perf_counter()
    hook = sys.excepthook
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["-file", prefix] + flags + [
                "--dtype", mode, "--events", ev, "--metrics", met])
    finally:
        # the CLI's event sinks and its flight-record hook end with it
        events.configure()
        sys.excepthook = hook
    wall = time.perf_counter() - t0
    launches = counts.read(key)
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[INFER]")]
    with open(ev) as f:
        recs = [json.loads(ln) for ln in f]
    with open(met) as f:
        epoch_ms = [json.loads(ln)["epoch_ms"] for ln in f]
    resolved = [r["resolved"] for r in recs if r["cat"] == "resolve"
                and r.get("requested") == "auto"]
    platform = [r["platform"] for r in recs if r["cat"] == "manifest"]
    val, test = (float(x) for x in _ACCURACY.search(lines[-1]).groups()) \
        if lines else (None, None)
    rec = {"mode": mode, "rc": rc, "val_acc": val, "test_acc": test,
           "infer": lines, "resolved": resolved, "platform": platform,
           "epoch_ms": epoch_ms,
           "steady_epoch_ms": float(np.median(epoch_ms[1:] or epoch_ms)),
           "wall_s": wall, "launches": launches,
           "plain_calls": {k: n - planned.get(k, 0) for k, n in
                           _build.instances_planned().items()
                           if n != planned.get(k, 0)}}
    if rc != 0 or test is None or test < floor or (gate_val
                                                   and val < floor):
        raise AssertionError(f"{tag} {mode}: below the {floor} % floor "
                             f"or failed: {rec}")
    if resolved != ["cuda"] or platform != ["gpu"] or rec["plain_calls"]:
        raise AssertionError(f"{tag} {mode}: not on the card's 'cuda' "
                             f"route alone: {rec}")
    if not all((launches[k] if k == "indegree_norm_masked"
                else launches[k][key]) for k in CUDA_ROUTE_KERNELS):
        raise AssertionError(f"{tag} {mode}: a kernel of the path never "
                             f"ran: {launches}")
    return rec


def reddit_pair(root, ds):
    """A DGL-layout pair at Reddit's shape from ``ds``, whose graph is
    symmetric with every self edge: ``reddit_data.npz`` (feature, label,
    node_types from the mask, whose codes are DGL's) and
    ``reddit_graph.npz``, a COO adjacency of one direction of each edge
    (source below destination), no self edge, every seventh edge given
    twice and the repeats after the rest, so that the converter's
    symmetrising, dedupe, sort and self-edge insertion all have work.
    Converted by :func:`convert_cli` with ``--no-csv``.  Holds the
    loaded graph to ``ds``'s edges as numpy orders them here, not
    through the converter's functions: the same row pointers, and each
    row its other neighbours ascending, then its self edge (the JAX
    script's order for a self edge it adds); the features, labels and
    mask to ``ds``'s.  Returns the write, convert and check seconds, the
    converter's peak RSS and the sizes."""
    import scipy.sparse as sp
    from roc_tpu_torch.core.graph import load_dataset
    raw = os.path.join(root, "reddit_raw")
    os.makedirs(raw)
    g = ds.graph
    V = g.num_nodes
    row_ptr = np.asarray(g.row_ptr)
    t0 = time.perf_counter()
    np.savez(os.path.join(raw, "reddit_data.npz"),
             feature=np.asarray(ds.features),
             label=np.asarray(ds.labels, dtype=np.int64),
             node_types=np.asarray(ds.mask, dtype=np.int64))
    dst = np.repeat(np.arange(V, dtype=np.int32), np.diff(row_ptr))
    src = np.asarray(g.col_idx, dtype=np.int32)
    one = src < dst
    dst, src = dst[one], src[one]
    del one
    n_one = int(dst.size)
    dst = np.concatenate([dst, dst[::7]])
    src = np.concatenate([src, src[::7]])
    raw_edges, repeats = int(dst.size), int(dst.size) - n_one
    sp.save_npz(os.path.join(raw, "reddit_graph.npz"),
                sp.coo_matrix((np.ones(dst.size, dtype=np.float32),
                               (dst, src)), shape=(V, V)),
                compressed=False)
    del dst, src
    write_s = time.perf_counter() - t0
    prefix = os.path.join(root, "reddit_conv", "reddit")
    rec = convert_cli("reddit", prefix, raw_dir=raw, no_csv=True)
    t0 = time.perf_counter()
    got = load_dataset(prefix, ds.in_dim, ds.num_classes)

    def order_keys(gr):
        # dst * (V + 1) + src, the self edge's src taken as V: ascending
        # within a row puts the self edge last
        d = np.repeat(np.arange(V, dtype=np.int64),
                      np.diff(np.asarray(gr.row_ptr)))
        c = np.asarray(gr.col_idx, dtype=np.int64)
        return d * (V + 1) + np.where(c == d, V, c)
    got_keys = order_keys(got.graph)
    # ds's rows are ascending but for a self edge in place; timsort
    # ("stable") sorts such runs in about one pass
    want_keys = np.sort(order_keys(g), kind="stable")
    same = {
        "graph": bool(np.array_equal(got.graph.row_ptr, row_ptr)
                      and np.array_equal(got_keys, want_keys)),
        "features": bool(np.array_equal(got.features, ds.features)),
        "labels": bool(np.array_equal(got.labels, ds.labels)),
        "mask": bool(np.array_equal(got.mask, ds.mask))}
    del got_keys, want_keys
    check_s = time.perf_counter() - t0
    out = {"V": got.graph.num_nodes, "E": got.graph.num_edges,
           "raw_edges": raw_edges, "raw_repeats": repeats,
           "in_dim": got.in_dim, "classes": got.num_classes,
           "raw_bytes": sum(os.path.getsize(os.path.join(raw, f))
                            for f in os.listdir(raw)),
           "write_raw_s": write_s, "convert_s": rec["wall_s"],
           "convert_rss_peak_gb": rec["rss_peak_gb"], "check_s": check_s,
           "same": same, "printed": rec["printed"]}
    del got
    if not all(same.values()):
        raise AssertionError(f"the converted Reddit pair differs: {out}")
    return out


def data_host(root, reddit):
    """Phase 23's host part: the port's converter run as a user runs it
    on cora-synth and karate (:func:`convert_pinned`), then
    :func:`reddit_pair` on ``reddit()``, the Reddit shape.  Logs one
    phase line per conversion; returns ``(record, {name: prefix})``."""
    t0 = time.perf_counter()
    droot = os.path.join(root, "data")
    os.makedirs(droot)
    conv = convert_pinned(droot)
    for name, (_, r) in conv.items():
        log({"phase": "data_convert", "dataset": name, **r})
    rec = {"convert": {k: r for k, (_, r) in conv.items()}}
    rec["reddit_pair"] = reddit_pair(droot, reddit())
    log({"phase": "data_reddit_pair", "card": card_line(),
         **rec["reddit_pair"]})
    rec["host_s"] = time.perf_counter() - t0
    return rec, {k: p for k, (p, _) in conv.items()}


def data_gates(torch, root, prefixes):
    """Phase 23's card part: the datasets :func:`data_host` converted
    (``prefixes``) through the port's CLI on the card, each run with its
    own launch counts: config 1 (:data:`CONFIG1`) in fp32 and in
    'mixed', each to test and val accuracy >= :data:`CONFIG1_FLOOR` on
    'cuda' with K4, K1, the masked K1 and K2 launched (:func:`cli_gate`),
    and the karate gate (:data:`KARATE`, test accuracy >=
    :data:`KARATE_FLOOR`) in fp32.  Logs one phase line per run and
    returns ``({run: record}, counts, seconds)``."""
    t0 = time.perf_counter()
    card = card_line()
    counts = Launches(torch)
    runs = {}
    # karate's val split is its two members beside the leaders: the
    # JAX gate holds test accuracy alone
    for tag, name, flags, floor, modes in (
            ("config1", "cora-synth", CONFIG1, CONFIG1_FLOOR,
             ("float32", "mixed")),
            ("karate", "karate", KARATE, KARATE_FLOOR, ("float32",))):
        for mode in modes:
            r = cli_gate(torch, counts, prefixes[name], flags, mode, floor,
                         root, tag, gate_val=tag == "config1")
            runs[f"{tag}/{mode}"] = r
            log({"phase": "data_gate", "run": tag, "card": card,
                 **{k: r[k] for k in (
                     "mode", "val_acc", "test_acc", "steady_epoch_ms",
                     "epoch_ms", "wall_s", "resolved", "launches")},
                 "infer": r["infer"][-1]})
    return runs, counts, time.perf_counter() - t0


class Launches:
    """The kernel wrappers' launch counts: :meth:`zero` sets them to 0,
    :meth:`read` returns them and adds them to ``counted[dtype][kernel]``,
    the table's sums, and :meth:`peek` returns them alone.  The masked
    K1's launches count in indegree_norm's and apart in masked_launches;
    the table gives each form its own row, so a path of dtype ``key``
    adds its masked launches to "indegree_norm_masked", the rest to
    "indegree_norm"."""

    def __init__(self, torch):
        from roc_tpu_torch.kernels import ell_spmm, graphnorm, spmm
        self.torch, self.graphnorm, self.spmm = torch, graphnorm, spmm
        self.kernels = (graphnorm.indegree_norm, graphnorm.scale_act,
                        spmm.csr_spmm, ell_spmm.ell_aggregate)
        self.counted = {key: {name: 0 for name in KERNELS}
                        for key in (F32, BF16)}

    def zero(self):
        from roc_tpu_torch.kernels import _build
        _build.zero_launches(*self.kernels)
        self.graphnorm.indegree_norm.masked_launches = 0
        self.spmm.csr_row_ptr.launches = 0

    def peek(self):
        self.torch.cuda.synchronize()
        return {k.__name__: dict(k.launches_by_dtype) for k in self.kernels}

    def read(self, key):
        got = self.peek()
        masked = self.graphnorm.indegree_norm.masked_launches
        for name, by in got.items():
            for k in (F32, BF16):
                self.counted[k][name] += by[k]
        self.counted[key]["indegree_norm"] -= masked
        self.counted[key]["indegree_norm_masked"] += masked
        got["indegree_norm_masked"] = masked
        got["csr_row_ptr"] = self.spmm.csr_row_ptr.launches
        return got


def zoo_child(out_path):
    """Phase 12 in a fresh process on card 0: builds (or loads) the
    kernels, runs :func:`zoo` with its own launch counts and writes the
    record, the counts and the F = 128 kernel rows to ``out_path``.  In
    the smoke's own process, after some 60 profiler runs, the later
    runs lost kernel records (a step's K4 time read half its launches'
    sum; a kernel's device time read below its bound), so the zoo's
    profiles run in a process of their own."""
    import torch
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    torch.cuda.set_device(0)
    set_fp32_matmul_precision()
    _build.library()
    counts = Launches(torch)
    entries = {key: {name: {} for name in KERNELS} for key in (F32, BF16)}
    rec = zoo(torch, torch.device("cuda"), entries, counts)
    with open(out_path, "w") as f:
        json.dump({"record": rec, "counted": counts.counted,
                   "zoo_shapes": {key: {name: e.get("zoo_shapes", [])
                                        for name, e in by.items()}
                                  for key, by in entries.items()}}, f)


def start_zoo_child(tmp):
    """:func:`zoo_child` pre-started, writing ``tmp``/zoo.json."""
    out = os.path.join(tmp, "zoo.json")
    return _Child(f"zoo_child({out!r})", 600, "phase 12 (zoo)")


def main() -> int:
    import shutil

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_")
    # the Reddit and products shapes are built on the host beside the
    # card's set-up and first phases, and mapped by every phase
    prep = subprocess.Popen(
        [sys.executable, "-c",
         f"import chip_smoke as s; s.prep_datasets({root!r})"],
        cwd=here, env=dict(os.environ, PYTHONPATH=here + os.pathsep
                           + os.environ.get("PYTHONPATH", "")))
    try:
        return _main(torch, root, prep, t_start)
    finally:
        if prep.poll() is None:
            prep.kill()
            prep.wait()
        _end_started()
        shutil.rmtree(root, ignore_errors=True)


def _main(torch, root, prep, t_start) -> int:
    """The phases of :func:`main`, the datasets from ``prep``
    (:func:`prep_datasets`) under ``root``."""
    from roc_tpu_torch.core.partition import padded_edge_list
    from roc_tpu_torch.kernels import _build
    from roc_tpu_torch.models.gcn import build_gcn
    from roc_tpu_torch.ops.dense import set_fp32_matmul_precision
    from roc_tpu_torch.serve.export import build_predictor
    from roc_tpu_torch.serve.server import Server
    from roc_tpu_torch.train.trainer import TrainConfig

    # 1. card
    card = card_line()
    set_fp32_matmul_precision()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log({"phase": "card", "card": card, "kind": kind,
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda})

    # 2. build
    _build.library()
    ptxas = [ln.strip() for entry in _build.build_log
             for ln in entry.splitlines() if "registers" in ln
             or "spill" in ln]
    log({"phase": "build", "seconds": _build.build_seconds,
         "ptxas": ptxas})

    # the zoo's process sets up during the ragged checks
    zoo_pre = start_zoo_child(root)

    # 3. kernels, in fp32 and in bf16
    log({"phase": "ragged", **ragged_checks(torch, dev)})
    reddit = os.path.join(root, "reddit")
    products = os.path.join(root, "products")

    # 12. the model zoo at ogbn-arxiv's shape, in a fresh process, run
    # here while the prep builds the Reddit shape (with --deep after the
    # prep): K1-K4 at F = 128, then every family's parity (or float64)
    # check, training runs (each with the counts zeroed just before and
    # read just after, added to the table's) and, with --deep, step
    # profiles
    # 23. the data phase: beside the zoo child only its host work (the
    # port's converter on cora-synth and karate, then, once the prep has
    # it, the Reddit shape as a DGL pair); config 1 and the karate gate
    # through the port's CLI on the card once the child has ended, so
    # that neither reads a time on a shared card
    if DEEP:
        _await_prep(prep, products)
    sys.stdout.flush()
    t12 = time.perf_counter()
    data, data_prefixes = _run_together([zoo_pre], lambda: data_host(
        root, lambda: (_await_prep(prep, reddit),
                       _map_dataset(reddit, LAYERS[-1]))[1]))
    t_zoo = time.perf_counter() - t12
    data["runs"], data_counts, gates_s = data_gates(
        torch, os.path.join(root, "data"), data_prefixes)
    with open(os.path.join(root, "zoo.json")) as f:
        zoo = json.load(f)
    log({"phase": "data_summary", "host_s": data["host_s"],
         "zoo_and_host_s": t_zoo, "gates_s": gates_s, "card": card,
         **{k: {x: r[x] for x in (
             "val_acc", "test_acc", "steady_epoch_ms", "wall_s")}
            for k, r in data["runs"].items()},
         "reddit_pair": {k: data["reddit_pair"][k] for k in (
             "write_raw_s", "convert_s", "convert_rss_peak_gb", "check_s")}})
    zrec = zoo["record"]
    log({"phase": "zoo_summary", "V": zrec["V"], "E": zrec["E"],
         "seconds": zrec["seconds"], "peak_mem_gb": zrec["peak_mem_gb"],
         "epoch_ms": {f: {k: r["epoch_ms"] for k, r in rec["train"].items()}
                      for f, rec in zrec["families"].items()}})
    prep_info = _await_prep(prep, reddit)
    ds = _map_dataset(reddit, LAYERS[-1], mmap=False)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = build_gcn(LAYERS)
    params = model.init_params(gen, device=dev)
    t0 = time.perf_counter()
    pred = build_predictor(model, ds,
                           TrainConfig(aggr_impl="cuda", symmetric=True),
                           params=params, backend="full")
    torch.cuda.synchronize()
    t_pred = time.perf_counter() - t0
    gctx = pred.gctx
    log({"phase": "data", "V": ds.graph.num_nodes,
         "E": ds.graph.num_edges, "in_dim": ds.in_dim,
         "classes": ds.num_classes, "dataset_s": prep_info["dataset_s"],
         "dataset_save_s": prep_info["save_s"],
         "dataset_wait_s": prep_info["wait_s"], "predictor_s": t_pred,
         "buckets": [list(a.shape) for a in gctx.ell_idx]})
    g = ds.graph

    def csr_adj(dtype):
        return torch.sparse_csr_tensor(
            torch.from_numpy(g.row_ptr).to(dev),
            torch.from_numpy(g.col_idx.astype(np.int64)).to(dev),
            torch.ones(g.num_edges, device=dev, dtype=dtype), size=(V, V),
            check_invariants=False)

    esrc, edst = (torch.from_numpy(a).to(dev)
                  for a in padded_edge_list(g, multiple=512))
    entries = {}
    for key, dtype in ((F32, torch.float32), (BF16, torch.bfloat16)):
        adj = csr_adj(dtype)
        entries[key] = kernel_checks(torch, dev, gctx, adj, g.num_edges,
                                     esrc, edst, dtype)
        if key == F32:
            # the SGC on 'cuda' (features on the card) runs K1 -> K4 -> K2
            # on the raw features, F = 602
            akx_rows = kernel_checks(torch, dev, gctx, adj, g.num_edges,
                                     esrc, edst, dtype,
                                     widths=((LAYERS[0], "none"),),
                                     with_csr=False)
        del adj
        torch.cuda.empty_cache()
        race(torch, dev, gctx, g.num_edges, esrc, edst, dtype)
        torch.cuda.empty_cache()
    del esrc, edst
    torch.cuda.empty_cache()
    if DEEP:
        # the gather's ceiling and every kernel table shape, and with
        # --old DIR the other tree's K3 and K4 in turns
        gather_races(torch, ds, gctx,
                     other_gathers(OTHER_TREE) if OTHER_TREE else None)

    # every main path below is driven with the counts zeroed just before
    # and read just after (Launches)
    counts = Launches(torch)
    zero_counts, read_counts, counted = counts.zero, counts.read, \
        counts.counted
    # phase 12's and the data phase's counted runs and the zoo's F = 128
    # rows join the table
    for key in (F32, BF16):
        for name in KERNELS:
            counted[key][name] += zoo["counted"][key][name] + \
                data_counts.counted[key][name]
            entries[key][name]["zoo_shapes"] = zoo["zoo_shapes"][key][name]

    # 4. serve slice: the serving path, fp32; the first 8-row and 64-row
    # requests profiled (the 64-row one was the slow one before)
    zero_counts()
    lat, results = slice_run(torch, pred, Server,
                             first=profiled(torch, pred, (8, 64)))
    launches = read_counts(F32)
    log({"phase": "slice", "requests": lat, "launches": launches})
    if not all(launches[k][F32] for k in ("indegree_norm", "scale_act",
                                          "ell_aggregate")):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    ref = serve_check(torch, pred, results, "float32")
    del pred, gctx, results
    torch.cuda.empty_cache()

    # 5. train parity: kernel routes against the plain route on the card
    parity, logits32 = train_parity(torch, ds, params)
    log({"phase": "train_parity", **parity})

    # 6. train slice: the training path, fp32
    zero_counts()
    record32 = record = train_slice(torch, ds, (("cuda", "float32"),
                                                ("cuda_csr", "float32")))
    train_launches = read_counts(F32)
    kernel_share(record, entries[F32])
    log({"phase": "train_slice", **record, "launches": train_launches})
    check_train_launches(train_launches, F32)

    # 7. where a steady step's device time goes (after the counts are
    # read: these steps are not part of the counted run)
    log({"phase": "train_profile", **train_profile(torch, ds)})

    # 8. mixed precision: serve, parity, train slices, profile
    pred = build_predictor(model, ds,
                           TrainConfig(aggr_impl="cuda", symmetric=True,
                                       dtype=torch.float32,
                                       compute_dtype=torch.bfloat16),
                           params=params, backend="full")
    zero_counts()
    lat, results = slice_run(torch, pred, Server)
    launches = read_counts(BF16)
    log({"phase": "slice_mixed", "requests": lat, "launches": launches})
    if not all(launches[k][BF16] for k in ("indegree_norm", "scale_act",
                                           "ell_aggregate")) or any(
            by[F32] for k, by in launches.items()
            if k not in ("csr_row_ptr", "indegree_norm_masked")):
        raise AssertionError(f"the mixed serving path did not run the "
                             f"bf16 kernels alone: {launches}")
    serve_check(torch, pred, results, "mixed", fp32_ref=ref)
    del pred, results, ref
    torch.cuda.empty_cache()
    parity_mixed, _ = train_parity(torch, ds, params, mode="mixed")
    log({"phase": "train_parity_mixed", **parity_mixed})
    zero_counts()
    record = train_slice(torch, ds, (("cuda", "mixed"),
                                     ("cuda", "bfloat16"),
                                     ("cuda_csr", "mixed")))
    train_launches_bf16 = read_counts(BF16)
    kernel_share(record, entries[BF16])
    log({"phase": "train_slice_bf16", **record,
         "launches": train_launches_bf16})
    check_train_launches(train_launches_bf16, BF16)
    if DEEP:
        log({"phase": "train_profile_mixed",
             **train_profile(torch, ds, mode="mixed")})

    # 9. dist_p1: the partitioned trainer at world size 1 over NCCL, in
    # this process, each dtype's slice with the counts zeroed just before
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            for mode, key, par, ref in (
                    ("float32", F32, parity, record32),
                    ("mixed", BF16, parity_mixed, record)):
                rec = {"mode": mode,
                       "parity": dist_parity(torch, ds, params, par, mode)}
                zero_counts()
                rec["slice"] = train_slice(
                    torch, ds, (("cuda", mode), ("cuda_csr", mode)),
                    make=_dist_trainer)
                rec["launches"] = read_counts(key)
                check_train_launches(rec["launches"], key)
                if mode == "float32" and DEEP:
                    # where the partitioned step's extra time goes
                    rec["profile"] = train_profile(torch, ds,
                                                   make=_dist_trainer)
                for k, r in rec["slice"].items():
                    r["trainer_epoch_ms"] = ref[k]["epoch_ms"]
                log({"phase": "dist_p1", **rec})
        finally:
            dist.destroy_process_group()

    # the kill drill's first process and phase 14's set up while
    # dist_p2's ranks run (a layout check, not a speed number)
    rec_root = os.path.join(root, "recovery")
    os.makedirs(rec_root)
    drill_pre = start_recovery_child(rec_root, reddit,
                                     "kill_in_async_save:4", "child1")
    layouts_pre = start_layouts_child(root, LAYERS[-1])

    # 10. dist_p2: two ranks on this card over gloo; their launches count
    # with the fp32 paths'
    rec, rank_launches = dist_p2(torch, ds, params, parity, logits32,
                                 reddit)
    for by in rank_launches:
        for name in ("indegree_norm", "scale_act", "ell_aggregate",
                     "csr_spmm"):
            counted[F32][name] += by[name][F32]
        counted[F32]["indegree_norm"] -= by["indegree_norm_masked"]
        counted[F32]["indegree_norm_masked"] += by["indegree_norm_masked"]
    log({"phase": "dist_p2", **rec})

    # 11. recovery: checkpointed, killed and resumed runs; the fp32 path's
    # and the mixed path's launches each read just after the path, the
    # resumed child's count with the fp32 paths'
    rec, f32, bf16, child = recovery(torch, ds, zero_counts, read_counts,
                                     rec_root, reddit, drill_pre)
    for name in ("indegree_norm", "scale_act", "ell_aggregate", "csr_spmm"):
        counted[F32][name] += child[name][F32]
    counted[F32]["indegree_norm"] -= child["indegree_norm_masked"]
    counted[F32]["indegree_norm_masked"] += child["indegree_norm_masked"]
    for key, got in ((F32, f32), (BF16, bf16)):
        if not (all(got[k][key] for k in ("indegree_norm", "scale_act",
                                           "csr_spmm")) and
                got["indegree_norm_masked"]) or (
                key == F32 and not got["ell_aggregate"][F32]):
            raise AssertionError(f"recovery: a {key} kernel of the path never "
                                 f"ran: {got}")
    rec["launches"] = {"float32": f32, "mixed": bf16, "child2": child}
    for tag in ("cuda_fp32", "cuda_csr_mixed"):
        r = rec[tag]
        log({"phase": "recovery_epoch_ms", "run": tag,
             **{f"{v}_steady_epoch_ms": r[v]["steady_epoch_ms"]
                for v in ("plain", "guard_only", "snapshot_only",
                          "recovered", "plain_again") if v in r},
             "overhead_share": r["overhead_share"],
             "plain_epoch_ms": r["plain"]["epoch_ms"],
             "recovered_epoch_ms": r["recovered"]["epoch_ms"],
             "async_saves": r["saves"]})
    log({"phase": "recovery_saves", **rec.get("save_timings", {}),
         "children_setup_s": [rec["kill_drill"]["child1_setup_s"],
                              rec["kill_drill"]["child2_setup_s"]]})
    log({"phase": "recovery", **rec})

    def add_counted(child):
        for key in (F32, BF16):
            for name in KERNELS:
                counted[key][name] += child["counted"][key][name]

    def read(name):
        with open(os.path.join(root, f"{name}.json")) as f:
            return json.load(f)

    # From here phases share the card two at a time (with --deep one
    # after another, for their times): 13 with 14, 15 with 16, 17 with
    # 19; 18, whose drills key on measured latency, runs alone.  Every
    # child set up one phase ahead.
    products_info = _await_prep(prep, products)
    if prep.wait() != 0:
        raise AssertionError(f"the dataset prep exited {prep.returncode}")
    log({"phase": "schedule", "deep": DEEP, "together": [] if DEEP else [
        ["serve_precomputed", "layouts"], ["memory", "dist_ring"],
        ["dist_mesh", "routes", "prewarm", "lint"]], "alone": ["fleet"]})
    memory_pre = start_memory_child(root, LAYERS[-1])
    ring_pre = start_ring_child(root, LAYERS[-1])

    # 13. the precomputed serving backend: akx, table, the artifacts and
    # the invalidation, each precompute with the counts zeroed just
    # before and read just after.  14. the large-graph layouts, in a
    # fresh process: with --deep races against K3 and K4 and the
    # block-dense race; reordering, the GCN on the layouts, the products
    # shape; its counted runs (the 'cuda' baselines) join the table
    sys.stdout.flush()
    akx_params = _run_together([layouts_pre], lambda: serve_precomputed(
        torch, ds, params, counts))
    save_fleet_params(root, akx_params, params)
    child = read("layouts")
    add_counted(child)
    lrec = child["record"]
    log({"phase": "layouts_summary", "seconds": lrec["seconds"],
         "auto": lrec["train"]["auto"],
         "products_dataset": products_info,
         "peak_mem_gb_products": lrec["products"]["peak_mem_gb"],
         "race_over_k4": {f"{r['F']}/{r['dtype']}": {
             k: v["over_k4"] for k, v in r.items()
             if isinstance(v, dict)}
             for r in lrec["race"]["rows"]} if "race" in lrec
         else "with --deep"})

    # 15. the memory tier, in a fresh process: the streamed GCN and SGC
    # (the walk on K3), remat, the autopilot, the drills; every run
    # counted.  16. the ring, the cost split and the partitioned
    # layouts: gloo ranks on this card, in a fresh process on the Reddit
    # shape's files; every rank's path counted
    refs_path = os.path.join(root, "mesh_refs.json")
    mesh_pre = start_mesh_child(root, LAYERS[-1], refs_path)
    routes_pre = start_routes_child(root, LAYERS[-1])
    prewarm_pre = start_prewarm_child(root)
    lint_pre = start_lint_child(root)
    sys.stdout.flush()
    t16 = time.perf_counter()
    _run_together([memory_pre, ring_pre])
    s16 = time.perf_counter() - t16
    child = read("memory")
    add_counted(child)
    mrec = child["record"]
    walk_row = mrec["walk_k3"]
    log({"phase": "memory_summary", "seconds": mrec["seconds"],
         "streamed_gcn_epoch_ms": {
             m: {t: r[t]["epoch_ms"] for t in ("host", "hbm")}
             for m, r in mrec["streamed_gcn"].items()},
         "walk_wall_ms": mrec["streamed_sgc"].get("walk", {}).get(
             "wall_ms", "with --deep"),
         "autopilot": {k: v["plan"]
                       for k, v in mrec["autopilot"].items()
                       if isinstance(v, dict)}})
    ring = read("ring")
    add_counted(ring)
    rrec = ring["record"]
    log({"phase": "dist_ring_summary", "seconds": s16,
         "pair_edges": rrec["p2"]["ranks"][0]["ring"]["pair_edges"],
         "padding_ratio": rrec["p2"]["ranks"][0]["ring"][
             "padding_ratio"],
         "ring_table_bytes": [r["ring"]["table_bytes"]
                              for r in rrec["p2"]["ranks"]],
         "rss_peak_gb": {f"p{n}": [r["rss_peak_gb"]
                                   for r in rrec[f"p{n}"]["ranks"]]
                         for n in (2, 4)},
         "step_ms": {k: v["step_ms"] for k, v in
                     rrec["p2"]["ranks"][0]["runs"].items()
                     if "step_ms" in v},
         "p4_peak_gb": [{h: (r[h]["peak_gb"], r[h]["modeled_gb"])
                         for h in ("ring", "gather")}
                        for r in rrec["p4"]["ranks"]]})

    # 17. partition-local loading from the reference's files, the
    # (parts, model) mesh and its two-writer checkpoint: gloo ranks on
    # this card, in a fresh process, held to phase 16's objectives.
    # 19. the chunked edge-list routes, the chunked head, the CLI's
    # compute flags and the checkpointed ELL max, in a fresh process;
    # every run of a kernel route counted
    runs16 = rrec["p2"]["ranks"][0]["runs"]
    with open(refs_path, "w") as f:
        json.dump({f"{h}_{m}": runs16[name]["losses"]
                   for (h, m), name in MESH_REFS.items()}, f)
    fleet_pre = start_fleet_child(root)
    sys.stdout.flush()
    t17 = time.perf_counter()
    _run_together([mesh_pre, routes_pre, prewarm_pre, lint_pre])
    s17 = time.perf_counter() - t17
    mesh = read("mesh")
    add_counted(mesh)
    routes = read("routes")
    add_counted(routes)
    prewarm = read("prewarm")
    add_counted(prewarm)
    prec = prewarm["record"]
    lint = read("lint")
    add_counted(lint)
    log({"phase": "lint_summary", "seconds": lint["record"]["seconds"],
         "runs": [{k: r[k] for k in (
             "impl", "mode", "walls_ms", "recorded_bytes", "modeled_bytes",
             "bytes_ratio", "findings", "kernel_threads", "sync_warnings",
             "witness")} for r in lint["record"]["runs"]], "card": card})
    log({"phase": "prewarm_summary", "seconds": prec["seconds"],
         "cold_library_s": prec["cold"]["library_s"],
         "cold_process_s": prec["cold"]["wall_s"],
         "warm_process_s": prec["warm"]["wall_s"],
         "warm_new_files": prec["warm"]["new_files"],
         "gcn_warm_s": {m: r["warm_s"] for m, r in prec["gcn"].items()},
         "gcn_instances": {m: sorted({i for x in r["slots"]
                                      for i in x["launched"]})
                           for m, r in prec["gcn"].items()},
         "rebuild_s": prec["rebuild"]["seconds"],
         "first_launch_ms": {k: v["first_ms"] for k, v in
                             prec["first_launch"].items()},
         "card": card})
    erec = routes["record"]
    log({"phase": "routes_summary", "seconds": erec["seconds"],
         "step_ms": {k: v["step_ms"] for k, v in erec["edge"].items()},
         "peak_gb": {k: v["peak_gb"] for k, v in erec["edge"].items()},
         "max_rel_err": {k: v.get("max_rel_err")
                         for k, v in erec["edge"].items()},
         "cli_max_abs_err": erec["cli"]["max_abs_err"],
         "telemetry_s": erec["telemetry"]["seconds"],
         "sentinel_s": erec["sentinel"]["seconds"],
         "telemetry": {m: {k: erec["telemetry"][m][k] for k in (
             "flops", "flops_kernels", "flops_rel_err", "peak_bytes",
             "modeled_bytes", "model_actual_ratio", "bit_equal")}
             | {k: erec["telemetry"][m]["record"][k] for k in (
                 "tflops_per_s", "mfu", "epoch_ms", "first_step_ms")}
             for m in ("float32", "mixed")},
         "telemetry_epoch_ms_on_off": {
             m: [erec["telemetry"][m]["epoch_ms_on"],
                 erec["telemetry"][m]["epoch_ms_off"]]
             for m in ("float32", "mixed")},
         "cli_epoch_ms_on_off": erec["cli"]["telemetry_epoch_ms"],
         "ell_max_peak_gb": erec["ell_max"]["peak_gb"],
         "ell_max_step_ms": erec["ell_max"]["step_ms"]})

    # 18. the replica fleet: sharded exports (counted), routers and
    # replicas on this card, the refresh and the drills, in a fresh
    # process on the Reddit shape's files
    sys.stdout.flush()
    t18 = time.perf_counter()
    fleet = run_fleet_child(root, pre=fleet_pre)
    add_counted(fleet)
    frec = fleet["record"]
    log({"phase": "fleet_summary", "seconds": time.perf_counter() - t18,
         "slices": {k: {x: v[x] for x in ("bytes_per_replica",
                                           "bytes_full", "slice_share")}
                    for k, v in frec["exports"].items()
                    if isinstance(v, dict) and "plan" in v},
         "router_median_ms": {k: frec[k]["router_median_ms"]
                              for k in ("akx_fp32", "akx_int8",
                                        "table")},
         "router_first_ms": {k: frec[k]["first_ms"]
                             for k in ("akx_fp32", "akx_int8", "table")},
         "server_median_ms": {k: frec[k]["server_median_ms"]
                              for k in ("akx_fp32", "akx_int8",
                                        "table")},
         "drills": sorted(frec["drills"])})
    mrec = mesh["record"]
    log({"phase": "dist_mesh_summary", "seconds": s17,
         "p2_s": mrec["p2_s"], "m2x2_s": mrec["m2x2_s"],
         "p2_read_bytes": [(r["read_bytes"], r["part_bytes"])
                           for r in mrec["p2"]],
         "m2x2_read_bytes": [{k: (v["read_bytes"], v["part_bytes"])
                              for k, v in r["runs"].items()}
                             for r in mrec["m2x2"]],
         "rss_gb": {j: {k: [r[k] for r in mrec[j]] for k in (
             "rss_start_gb", "rss_setup_gb", "rss_peak_gb", "rss_end_gb")}
             for j in ("p2", "m2x2")},
         "p16_rss_peak_gb": [r["rss_peak_gb"]
                             for r in rrec["p2"]["ranks"]],
         "gpu_peak_gb_gather_fp32": {
             "p2_1d": [r["peak_gb"] for r in mrec["p2"]],
             "m2x2": [r["runs"]["gather_float32"]["peak_gb"]
                      for r in mrec["m2x2"]]},
         "m2x2_max_rel_vs_1d": {k: max(r["runs"][k]["max_rel_vs_1d"]
                                       for r in mrec["m2x2"])
                                for k in mrec["m2x2"][0]["runs"]},
         "m2x2_bit_equal_1d": {k: all(r["runs"][k]["bit_equal_1d"]
                                      for r in mrec["m2x2"])
                               for k in mrec["m2x2"][0]["runs"]},
         "m2x2_peak_gb": [{k: v["peak_gb"] for k, v in r["runs"].items()}
                          for r in mrec["m2x2"]],
         "save": [r["runs"]["gather_float32"]["save"]
                  for r in mrec["m2x2"]]})
    hop_rows = [h for r in rrec["p2"]["ranks"] for h in r["hop_checks"]]

    table = []
    for key, tag in ((F32, "fp32"), (BF16, "bf16")):
        for name, e in entries[key].items():
            table.append({
                "name": f"{name}[{tag}]", "route": "cuda",
                "source": e["source"], "replaces": e["replaces"],
                "launches": counted[key][name],
                "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                "device_ms": e["device_ms"],
                "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                "bound_by": e["bound_by"], "library_ms": e["library_ms"],
                **({"row_ptr_ms": e["row_ptr_ms"]}
                   if "row_ptr_ms" in e else {}),
                "shapes": e["shapes"],
                **({"zoo_shapes": e["zoo_shapes"]}
                   if "zoo_shapes" in e else {}),
                **({"akx_shapes": akx_rows[name]["shapes"]}
                   if key == F32 and akx_rows[name]["shapes"] else {}),
                **({"walk_shapes": [walk_row]}
                   if key == F32 and name == "csr_spmm" else {}),
                **({"ring_shapes": [h for h in hop_rows if h["dtype"] == (
                    "torch.float32" if key == F32 else "torch.bfloat16")]}
                   if name == "csr_spmm" else {})})
    log({"total_s": time.perf_counter() - t_start,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    log({"kernels": table})
    print(card, flush=True)
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--attention-race"]:
        import torch
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(1)
        attention_race(sys.argv[2] if len(sys.argv) > 2 else None)
        sys.exit(0)
    if sys.argv[1:2] == ["--first-gather"]:
        import torch
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(1)
        first_gather(sys.argv[2] if len(sys.argv) > 2 else None)
        sys.exit(0)
    if sys.argv[1:2] == ["--gather-race"]:
        import torch
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            sys.exit(1)
        rest = sys.argv[2:]
        other = None
        if "--old" in rest:
            other = rest[rest.index("--old") + 1]
            del rest[rest.index("--old"):rest.index("--old") + 2]
        gather_race_main(rest[0] if rest else None, other)
        sys.exit(0)
    if "--deep" in sys.argv[1:]:
        os.environ["CHIP_SMOKE_DEEP"] = "1"
        DEEP = True
    if "--old" in sys.argv[1:]:
        OTHER_TREE = sys.argv[sys.argv.index("--old") + 1]
    sys.exit(main())
