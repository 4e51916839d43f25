"""Command-line training driver, the subset of ``roc_tpu/train/cli.py``
that the port covers: the reference's flags (``gnn.cc:114-179``) —
``-lr``, ``-e/-epoch``, ``-dropout/-dr``, ``-decay/-wd``, ``-decay-rate``,
``-decay-step/-ds``, ``-file``, ``-layers`` (dash-separated, e.g.
``602-256-41``: input width, hidden widths, classes), ``-seed``,
``-verbose/-v`` — and ``--model`` (every family of
``models.model_builders()``: gcn, sage, gin, gat, sgc, appnp, gcn2) with
its knobs ``--heads``, ``--hops``, ``--alpha``, ``--lam`` and
``--learn-eps``, ``--impl``, ``--fuse``, ``--dtype``, ``--head-chunk``,
``--eval-every``, ``--parts``, ``--mesh``, ``--dist-backend``, ``--halo``,
``--partition``, ``--rebalance``, ``--cpu``, the memory
flags ``--memory``, ``--features``, ``--remat`` and ``--prefetch``, and the
checkpoint and recovery flags ``--checkpoint``, ``--checkpoint-every``,
``--resume``, ``--recovery``, ``--max-retries``, ``--preempt-grace``,
``--async-save``, ``--fault`` and ``--events``, ``--eval-only`` and
``--save-logits``, and the telemetry flags ``--metrics`` and
``--profile-dir``, with the JAX CLI's meanings and exit codes.  ``--impl``
takes the ported counterparts of the JAX CLI's choices: ``auto`` (the
default, as in the JAX CLI: the JAX rule, 'ell', 'sectioned' or
'flat_sum' by the graph's size, through this card's row,
train/trainer.py ``resolve_auto_impl_probed``, with a ``resolve`` event
giving the JAX rule's answer beside the route), ``cuda`` (its
``pallas``), ``ell``, ``segment``, the chunked edge-list sums
``blocked`` and ``scan`` and the large-graph layouts ``sectioned``,
``flat_sum`` and ``bdense``;
``--dtype`` its ``float32``, ``bfloat16`` and ``mixed``
(train/trainer.py ``resolve_dtypes``); ``--reorder bfs|lpa`` relabels
the vertices before training (core/reorder.py), with a ``plan`` event;
``--head-chunk`` sets the classification head's row block
(train/trainer.py ``resolve_head_chunk``).  ``--eval-only`` runs one
inference pass, typically after ``--resume``, prints its ``[INFER]``
line and exits 0; ``--save-logits PATH`` writes the ``[V, C]`` fp32
logits as ``.npy`` after training or that pass, in the original vertex
order under ``--reorder``.  ``--metrics PATH`` appends each eval record
to PATH as JSONL (``TrainConfig.metrics_path``; on a partitioned run
every rank appends its own, stamped with its ``proc``).
``--profile-dir DIR`` trains one epoch, then one epoch inside a profiler
trace written to DIR with the loop's phases as named ranges, then the
rest (utils/profiling.py); read a run's files with
``python -m roc_tpu_torch.report EVENTS --metrics PATH``.
``--memory auto`` (the default, as in the JAX CLI) lets the memory
autopilot (core/memory.py) choose between device-resident and
host-streamed features and rematerialisation by the device's memory; an
explicit ``--features host`` or ``--remat`` switches it to ``manual``.

Runs on the card unless ``--cpu`` is given; without a card and without
``--cpu`` it exits with an error.  Without ``-file`` it trains on a
synthetic dataset (512 vertices, degree 8).  Prints the reference's
``[INFER]`` line at every eval (rank 0 only).

``--parts 1`` (the default) trains on one device (``Trainer``);
``--parts N`` trains N partitions, one per rank of a process group
(parallel/distributed.py ``DistributedTrainer``).  ``--mesh PxM`` (the
JAX CLI's vocabulary; P must equal ``--parts``) runs the ``(parts,
model)`` mesh on P x M ranks: each part's M model ranks keep the params
and Adam moments sharded at rest.  The ranks come from ``torchrun``,
whose environment gives the rank and world size (which must equal N, or
P x M; parallel/multihost.py ``init_distributed``); rank r takes card
``cuda:<local rank>``.  The backend is
``nccl`` on the card and ``gloo`` with ``--cpu``; ``--dist-backend``
overrides it.  Only rank 0 prints, emits events to the console or
``--events``, and writes checkpoints.  ``--halo ring`` rotates the parts'
rows around the ranks instead of all-gathering them (O(V/P) rows a
rank; ``--memory auto`` picks it when the gather does not fit);
``--partition greedy|cost|auto`` picks the split (``auto``, the default,
is the cost model's), and ``--rebalance`` refits the cost model at each
eval and repartitions between epochs.

``--recovery --checkpoint PREFIX`` trains in rounds of
``--checkpoint-every`` epochs (default: ``--eval-every``) under a
keep-last-3 rotation of ``PREFIX.<epoch>/`` checkpoint directories
(format v3, which the JAX package reads too), resumes from the newest
intact one on start — so re-invoking the same command after a crash
continues the run, at another ``--parts`` too — and retries numeric
failures, stalls and I/O errors from the last good one.  A preemption
(SIGTERM/SIGINT), a stall or an I/O failure it cannot retry exits 75,
"restartable".  ``--fault site:epoch`` arms one drill
(resilience/inject.py).

    python -m roc_tpu_torch.train.cli -layers 16-16-4 -e 50 -v
    python -m roc_tpu_torch.train.cli --cpu -layers 16-16-4 -e 20 -v
    python -m roc_tpu_torch.train.cli --cpu --model gat --heads 2 \
        -layers 16-16-4 -e 20
    python -m roc_tpu_torch.train.cli -layers 16-16-4 -e 50 --dtype mixed
    python -m roc_tpu_torch.train.cli --cpu -layers 16-16-4 -e 20 \
        --features host --prefetch 1 --remat
    torchrun --standalone --nproc-per-node 2 -m roc_tpu_torch.train.cli \
        --parts 2 --cpu -layers 16-16-4 -e 20
    torchrun --standalone --nproc-per-node 4 -m roc_tpu_torch.train.cli \
        --parts 4 --halo ring --partition cost --rebalance --cpu \
        -layers 16-16-4 -e 20
    torchrun --standalone --nproc-per-node 4 -m roc_tpu_torch.train.cli \
        --parts 2 --mesh 2x2 --cpu -layers 16-16-4 -e 20
    python -m roc_tpu_torch.train.cli --cpu -layers 16-16-4 -e 20 \
        --recovery --checkpoint /tmp/ck --checkpoint-every 2 \
        --fault sigkill:5     # dies; the same command again resumes
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

from ..models import model_builders
from .trainer import DTYPE_MODES

# the JAX CLI's --impl choices that have a ported route, by port name
IMPLS = ("cuda", "ell", "segment", "blocked", "scan", "auto", "sectioned",
         "flat_sum", "bdense")
DIST_BACKENDS = ("nccl", "gloo")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="roc_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    # reference flags (gnn.cc:114-179); defaults from gnn.cc:30-41
    ap.add_argument("-lr", type=float, default=0.01, dest="lr")
    ap.add_argument("-e", "-epoch", type=int, default=200, dest="epochs")
    ap.add_argument("-dropout", "-dr", type=float, default=0.5,
                    dest="dropout")
    ap.add_argument("-decay", "-wd", type=float, default=0.05,
                    dest="weight_decay")
    ap.add_argument("-decay-rate", type=float, default=1.0,
                    dest="decay_rate")
    ap.add_argument("-decay-step", "-ds", type=int, default=100,
                    dest="decay_steps")
    ap.add_argument("-file", type=str, default=None, dest="file",
                    help="dataset prefix (<prefix>.add_self_edge.lux / "
                         ".feats.bin|.feats.csv / .label / .mask)")
    ap.add_argument("-layers", type=str, default="16-16-4",
                    help="dash-separated dims, e.g. 602-256-41")
    ap.add_argument("-seed", type=int, default=1)
    ap.add_argument("-verbose", "-v", action="store_true",
                    help="echo the run's configuration to stderr")
    ap.add_argument("--model", choices=sorted(model_builders()),
                    default="gcn")
    ap.add_argument("--heads", type=int, default=None,
                    help="attention heads for --model gat (hidden "
                         "dims must divide by it; output layer stays "
                         "single-head)")
    ap.add_argument("--hops", type=int, default=None,
                    help="for --model sgc/appnp: propagation depth k "
                         "(sgc: logits = softmax(S^k X W), default 2; "
                         "appnp: k teleport-anchored hops after the "
                         "MLP, default 10)")
    ap.add_argument("--alpha", type=float, default=None,
                    help="for --model appnp/gcn2: teleport / initial-"
                         "residual strength (default 0.1)")
    ap.add_argument("--lam", type=float, default=None,
                    help="for --model gcn2: identity-mapping decay "
                         "(beta_l = log(lam/l + 1); default 0.5)")
    ap.add_argument("--learn-eps", action="store_true", default=None,
                    help="for --model gin: learnable per-layer "
                         "epsilon self-weight (zero-init GIN-0) "
                         "instead of the fixed self-add")
    ap.add_argument("--impl", default="auto", choices=IMPLS,
                    help="aggregation route: auto (default, as the JAX "
                         "CLI's) = the JAX rule by the graph's size "
                         "('ell', 'sectioned' past the VMEM table size, "
                         "'flat_sum' from 20M edges) through this card's "
                         "measured row; cuda = the hand-written kernels "
                         "(K1 -> K4 -> K2), ell / segment = the plain "
                         "PyTorch sums, blocked / scan = the chunked "
                         "edge-list sums, sectioned / flat_sum / bdense = "
                         "the large-graph layouts")
    ap.add_argument("--reorder", default="none",
                    choices=["none", "bfs", "lpa"],
                    help="vertex relabeling for gather locality "
                         "(core/reorder.py; 'lpa' = label-propagation "
                         "communities, the order bdense rides on); the "
                         "metrics do not depend on it")
    ap.add_argument("--fuse", default="auto", choices=["auto", "on", "off"],
                    help="fold norm -> aggregate -> norm [-> relu] chains "
                         "into one fused aggregation op")
    ap.add_argument("--dtype", default="float32", choices=DTYPE_MODES,
                    help="float32 = the reference's pure-fp32 "
                         "semantics; bfloat16 = everything (incl. "
                         "params) in bf16; mixed = fp32 master params "
                         "+ bf16 features/activations/aggregation (the "
                         "kernels' bf16 instances)")
    ap.add_argument("--memory", default="auto", choices=["auto", "manual"],
                    help="auto (default): the memory autopilot picks "
                         "features/remat by the device's memory "
                         "(core/memory.py); explicit --features host or "
                         "--remat switch it to manual")
    ap.add_argument("--features", default="hbm", choices=["hbm", "host"],
                    help="hbm = input features on the device; host = in "
                         "host memory, streamed through the first layer "
                         "in row blocks (needs a streamable head)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute activations in the backward instead "
                         "of saving them")
    ap.add_argument("--prefetch", default="auto",
                    help="staging-pool depth for --features host: blocks "
                         "the background stager runs ahead (auto = 1, "
                         "double-buffered; 0 = synchronous)")
    ap.add_argument("--head-chunk", default="auto",
                    help="chunked output head: the classification-head "
                         "linear in blocks of this many vertex rows "
                         "(the same values; dW to fp32 rounding); "
                         "'auto' (default) chunks at 65536 rows once the "
                         "rows reach 262144, 0 disables")
    ap.add_argument("--eval-only", action="store_true",
                    help="run one inference pass (typically with "
                         "--resume), print its [INFER] line and exit")
    ap.add_argument("--save-logits", type=str, default=None,
                    help="write the [V, C] inference logits here (.npy, "
                         "float32, the ORIGINAL vertex order even under "
                         "--reorder) after training or --eval-only")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--parts", type=int, default=1,
                    help="graph partitions, one per rank (launch N > 1 "
                         "ranks with torchrun --nproc-per-node N)")
    ap.add_argument("--mesh", type=str, default="auto",
                    help="rank mesh PxM (parts x model), e.g. 2x2: P "
                         "must equal --parts and M > 1 shards the params "
                         "and Adam moments over each part's M model ranks "
                         "at rest (launch P*M ranks); 'auto' (default) = "
                         "every rank on the parts axis, the 1-D run")
    ap.add_argument("--halo", default="gather", choices=["gather", "ring"],
                    help="halo exchange for --parts > 1: gather = every "
                         "rank all-gathers every part's rows; ring = the "
                         "parts' rows rotate around the ranks (O(V/P) "
                         "rows a rank)")
    ap.add_argument("--partition", default="auto",
                    choices=["greedy", "cost", "auto"],
                    help="split for --parts > 1: greedy = the reference's "
                         "edge sweep, cost = the cost model's minimax "
                         "split, auto (default) = cost")
    ap.add_argument("--rebalance", action="store_true",
                    help="--parts > 1: refit the per-partition cost model "
                         "to the measured epoch times at each eval and "
                         "repartition when the predicted gain of the "
                         "largest part's cost exceeds 10%% (at most 2 "
                         "times a run; full-batch training does not "
                         "depend on the split)")
    ap.add_argument("--dist-backend", default=None, choices=DIST_BACKENDS,
                    help="torch.distributed backend for --parts > 1 "
                         "(default: nccl on the card, gloo with --cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernel route then runs the "
                         "kernels' plain versions)")
    ap.add_argument("--no-compile-cache", action="store_true",
                    help="leave the build cache off (utils/compile_cache."
                         "py; default on: the kernel library and the native "
                         "planners build once into $ROC_TPU_TORCH_CACHE_DIR "
                         "or ~/.cache/roc_tpu_torch/kernels, and later runs "
                         "load them); off, they build in the checkout")
    ap.add_argument("--cache-min-secs", type=float, default=None,
                    help="the JAX CLI's compile-cache write threshold; the "
                         "port keeps its one kernel library whatever its "
                         "build time, so the value is recorded in the run "
                         "manifest (TrainConfig.cache_min_compile_secs) and "
                         "changes nothing")
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="save params + Adam state here after training "
                         "(a v3 checkpoint directory); with --recovery, "
                         "the rotation's PREFIX")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="also save every N epochs")
    ap.add_argument("--resume", type=str, default=None,
                    help="restore a checkpoint (the port's or the JAX "
                         "package's) before training")
    ap.add_argument("--recovery", action="store_true",
                    help="checkpoint-restart recovery: train in "
                         "checkpointed rounds under a keep-last-3 "
                         "rotation at the --checkpoint PREFIX, resume "
                         "from the newest intact checkpoint on start, "
                         "retry numeric failures / stalls / I/O errors "
                         "from the last good one (--max-retries); arms "
                         "the SIGTERM/SIGINT preemption handler; exits "
                         "75 (restartable) on preemption")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="recovery retry budget per failure streak")
    ap.add_argument("--preempt-grace", type=float, default=None,
                    dest="preempt_grace",
                    help="arm the SIGTERM/SIGINT preemption handler with "
                         "this grace window in seconds (--recovery arms "
                         "it with 30): the first signal finishes the "
                         "epoch's step, writes an emergency checkpoint "
                         "and exits 75; a second signal kills")
    ap.add_argument("--async-save", default="auto",
                    choices=["auto", "on", "off"], dest="async_save",
                    help="the recovery rotation saves on a background "
                         "thread (the step path pays the finite guard and "
                         "the host snapshot); auto = on for one process")
    ap.add_argument("--fault", type=str, default=None,
                    help="arm one drill fault, site:epoch[:rank]; sites "
                         "nan_grads, sigkill, sigterm, kill_in_save, "
                         "kill_in_async_save, shard_corrupt, saver_stall, "
                         "bitflip_checkpoint, staging_io, stall_compile "
                         "(env: ROC_TPU_FAULT)")
    ap.add_argument("--events", type=str, default=None,
                    help="structured event-log JSONL path (also "
                         "ROC_TPU_EVENTS)")
    ap.add_argument("--metrics", type=str, default=None,
                    help="training-metrics JSONL path (one record per "
                         "eval)")
    ap.add_argument("--profile-dir", type=str, default=None,
                    help="write a torch.profiler trace of one epoch here")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    layers = [int(x) for x in args.layers.split("-")]
    if len(layers) < 2:
        print("error: -layers needs at least in-dim and classes",
              file=sys.stderr)
        return 2
    if args.eval_every < 1:
        print("error: --eval-every must be >= 1", file=sys.stderr)
        return 2
    if args.parts < 1:
        print("error: --parts must be >= 1", file=sys.stderr)
        return 2
    if args.rebalance and args.parts <= 1:
        print("error: --rebalance requires --parts > 1 (rebalancing "
              "moves partition boundaries over the ranks)", file=sys.stderr)
        return 2
    if args.halo == "ring" and args.parts <= 1:
        print("error: --halo ring requires --parts > 1 (the ring "
              "rotates parts over the ranks)", file=sys.stderr)
        return 2
    if args.recovery and not args.checkpoint:
        print("error: --recovery needs --checkpoint PREFIX (the rotation "
              "writes <prefix>.<epoch>/ checkpoint directories there)",
              file=sys.stderr)
        return 2
    if args.max_retries < 0:
        print("error: --max-retries must be >= 0", file=sys.stderr)
        return 2
    from .trainer import (TrainConfig, resolve_head_chunk, resolve_mesh,
                          resolve_prefetch)
    try:
        resolve_prefetch(TrainConfig(prefetch=args.prefetch))
    except ValueError as e:
        print(f"error: --prefetch: {e}", file=sys.stderr)
        return 2
    # the trainer's validator, as for --prefetch
    try:
        resolve_head_chunk(TrainConfig(head_chunk=args.head_chunk), 1 << 30)
    except ValueError as e:
        print(f"error: --head-chunk: {e}", file=sys.stderr)
        return 2
    # the JAX CLI's validator: the same PxM vocabulary and checks
    try:
        _, mesh_model = resolve_mesh(TrainConfig(mesh=args.mesh),
                                     num_parts=args.parts)
    except ValueError as e:
        print(f"error: --mesh: {e}", file=sys.stderr)
        return 2
    if args.fault:
        from ..resilience import inject
        try:
            inject.parse(args.fault)
        except ValueError as e:
            print(f"error: --fault: {e}", file=sys.stderr)
            return 2
    try:
        model = _build_model(args, layers)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    world = int(os.environ.get("WORLD_SIZE", "1"))
    ranks = args.parts * mesh_model
    if world != ranks:
        print(f"error: --parts {args.parts} --mesh {args.mesh} needs "
              f"{ranks} rank(s) but the launcher started {world} "
              f"(torchrun --nproc-per-node {ranks})", file=sys.stderr)
        return 2
    from .trainer import resolve_device
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"error: {e} (or --cpu)", file=sys.stderr)
        return 2
    if not args.no_compile_cache:
        from ..utils.compile_cache import enable_compile_cache
        enable_compile_cache(min_compile_secs=args.cache_min_secs)
    rank = 0
    if ranks > 1:
        import torch
        import torch.distributed as dist
        from ..parallel.multihost import init_distributed
        backend = args.dist_backend or ("gloo" if args.cpu else "nccl")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        init_distributed(backend)
        rank = dist.get_rank()
    from ..obs import events
    if rank != 0:
        events.configure(console=False)
    elif args.events:
        events.configure(jsonl_path=args.events)
    try:
        return _train(args, layers, model, device, rank, ranks)
    finally:
        if ranks > 1:
            dist.destroy_process_group()


# each model knob: its attribute, flag, builder keyword and the models
# whose builder takes it
_KNOBS = (("heads", "--heads", "heads", ("gat",)),
          ("learn_eps", "--learn-eps", "learn_eps", ("gin",)),
          ("hops", "--hops", "k", ("sgc", "appnp")),
          ("alpha", "--alpha", "alpha", ("appnp", "gcn2")),
          ("lam", "--lam", "lam", ("gcn2",)))


def _build_model(args, layers):
    """The model of ``--model`` through the registry, given only the
    knobs that were on the command line (the builder's defaults fill in
    the rest).  Raises ValueError on a knob given to a model without it
    (the JAX CLI's check) or a value its builder refuses."""
    kwargs = {}
    for attr, flag, kw, models in _KNOBS:
        value = getattr(args, attr)
        if value is None:
            continue
        if args.model not in models:
            raise ValueError(f"{flag} applies to --model "
                             f"{'/'.join(models)} only")
        kwargs[kw] = value
    return model_builders()[args.model](layers, dropout_rate=args.dropout,
                                        **kwargs)


def _train(args, layers, model, device, rank, ranks) -> int:
    from ..core.graph import load_dataset, synthetic_dataset
    from ..obs.events import emit
    from ..obs.heartbeat import StallFailure
    from ..ops.dense import set_fp32_matmul_precision
    from ..resilience import preempt
    from ..resilience.preempt import Preempted, RESTARTABLE_EXIT_CODE
    from ..utils.checkpoint import checkpoint_trainer, restore_trainer
    from .trainer import TrainConfig, Trainer, resolve_dtypes
    set_fp32_matmul_precision()
    if args.file:
        ds = load_dataset(args.file, in_dim=layers[0],
                          num_classes=layers[-1])
    else:
        ds = synthetic_dataset(512, 8, in_dim=layers[0],
                               num_classes=layers[-1], seed=args.seed)
    perm = None
    if args.reorder != "none":
        from ..core.reorder import ORDERINGS, apply_vertex_order
        t0 = time.time()
        ds, perm = apply_vertex_order(ds, ORDERINGS[args.reorder](ds.graph),
                                      order_name=args.reorder)
        emit("plan", f"reorder={args.reorder} applied in "
             f"{time.time() - t0:.1f}s", reorder=args.reorder,
             reorder_s=round(time.time() - t0, 2))
    verbose = args.verbose and rank == 0
    if verbose:
        print(f"# dataset={ds.name} V={ds.graph.num_nodes} "
              f"E={ds.graph.num_edges} layers={layers} "
              f"model={args.model} lr={args.lr} "
              f"wd={args.weight_decay} dropout={args.dropout} "
              f"decay={args.decay_rate}/{args.decay_steps} "
              f"impl={args.impl} reorder={args.reorder} fuse={args.fuse} "
              f"dtype={args.dtype} memory={args.memory} "
              f"features={args.features} remat={args.remat} "
              f"prefetch={args.prefetch} "
              f"parts={args.parts} mesh={args.mesh} halo={args.halo} "
              f"partition={args.partition} rebalance={args.rebalance} "
              f"head_chunk={args.head_chunk} device={device}",
              file=sys.stderr)
    dtype, compute_dtype = resolve_dtypes(args.dtype)
    memory = args.memory
    if memory == "auto" and (args.halo != "gather"
                             or args.features != "hbm" or args.remat):
        # explicit residency flags win over the autopilot
        memory = "manual"
    cfg = TrainConfig(
        learning_rate=args.lr, weight_decay=args.weight_decay,
        dropout_rate=args.dropout, decay_rate=args.decay_rate,
        decay_steps=args.decay_steps, epochs=args.epochs, seed=args.seed,
        eval_every=args.eval_every, verbose=True, aggr_impl=args.impl,
        aggr_fuse=args.fuse, dtype=dtype, compute_dtype=compute_dtype,
        async_save=args.async_save, fault=args.fault, memory=memory,
        features=args.features, remat=args.remat, prefetch=args.prefetch,
        halo=args.halo, partition=args.partition, rebalance=args.rebalance,
        mesh=args.mesh, head_chunk=args.head_chunk,
        metrics_path=args.metrics,
        cache_min_compile_secs=args.cache_min_secs)
    if args.recovery or args.preempt_grace is not None:
        preempt.install(args.preempt_grace if args.preempt_grace is not None
                        else preempt.DEFAULT_GRACE_S)
    if ranks > 1:
        from ..parallel.distributed import DistributedTrainer
        trainer = DistributedTrainer(model, ds, args.parts, cfg,
                                     device=device)
    else:
        trainer = Trainer(model, ds, cfg, device=device)
    if args.resume:
        restore_trainer(trainer, args.resume)
        emit("run", f"resumed from {args.resume} at epoch "
             f"{trainer.epoch}", epoch=trainer.epoch)

    def save_logits():
        if not args.save_logits:
            return
        import numpy as np
        # every rank takes part in a partitioned predict; rank 0 writes
        logits = trainer.predict().float().cpu().numpy()
        if rank != 0:
            return
        if perm is not None:
            # row i of the reordered graph is original vertex perm[i]
            out = np.empty_like(logits)
            out[perm] = logits
            logits = out
        np.save(args.save_logits, logits)
        emit("run", f"logits [{logits.shape[0]}, {logits.shape[1]}] "
             f"saved to {args.save_logits}", path=args.save_logits)

    if args.eval_only:
        from .trainer import format_metrics
        m = trainer.evaluate()
        if rank == 0:
            print(format_metrics(trainer.epoch, m), flush=True)
        save_logits()
        return 0
    if args.profile_dir:
        from ..utils.profiling import trace
        trainer.train(1)  # the first step outside the trace
        # the traced epoch's phases as named ranges; the CLI never sets
        # TrainConfig.profile_dir (the loop would nest a second profiler)
        trainer.timer.annotate = True
        try:
            with trace(args.profile_dir):
                trainer.train(1)
                trainer.sync()
        finally:
            trainer.timer.annotate = False
        emit("run", f"profile written to {args.profile_dir}",
             path=args.profile_dir)
    t0 = time.perf_counter()
    remaining = args.epochs - trainer.epoch
    try:
        if args.recovery:
            from ..resilience.recovery import (CheckpointRotation,
                                               train_with_recovery)
            from .trainer import resolve_async_save
            rotation = CheckpointRotation(args.checkpoint, keep=3,
                                          async_save=resolve_async_save(cfg))
            every = (args.checkpoint_every if args.checkpoint_every > 0
                     else args.eval_every)
            train_with_recovery(trainer, args.epochs, rotation,
                                checkpoint_every=every,
                                max_retries=args.max_retries)
        elif args.checkpoint and args.checkpoint_every > 0:
            while trainer.epoch < args.epochs:
                trainer.train(min(args.checkpoint_every,
                                  args.epochs - trainer.epoch))
                checkpoint_trainer(trainer, args.checkpoint)
        else:
            trainer.train(max(remaining, 0))
        trainer.sync()
    except Preempted as e:
        # --recovery wrote the emergency checkpoint through its rotation;
        # the plain path persists --checkpoint here (a refused poisoned
        # state or an unwritable one still exits restartable)
        if not args.recovery and args.checkpoint:
            from ..resilience.recovery import NumericFailure
            try:
                checkpoint_trainer(trainer, args.checkpoint)
            except (NumericFailure, OSError) as nf:
                emit("resilience", f"emergency checkpoint failed: {nf}",
                     kind="preempt", epoch=trainer.epoch)
        emit("resilience", f"preempted at epoch {trainer.epoch} ({e}) — "
             f"exiting {RESTARTABLE_EXIT_CODE} (restartable)",
             kind="restartable_exit", epoch=trainer.epoch)
        return RESTARTABLE_EXIT_CODE
    except StallFailure as e:
        emit("resilience", f"{e} — exiting {RESTARTABLE_EXIT_CODE} "
             f"(restartable)", kind="restartable_exit", epoch=trainer.epoch)
        return RESTARTABLE_EXIT_CODE
    except OSError as e:
        if not args.recovery:
            raise
        emit("resilience", f"I/O failure {e!r} — exiting "
             f"{RESTARTABLE_EXIT_CODE} (restartable)",
             kind="restartable_exit", epoch=trainer.epoch)
        return RESTARTABLE_EXIT_CODE
    if verbose and remaining > 0:
        dt = time.perf_counter() - t0
        print(f"# {remaining} epochs in {dt:.1f}s "
              f"({1000.0 * dt / remaining:.1f} ms/epoch)", file=sys.stderr)
    if args.checkpoint and not args.recovery:
        # under --recovery the rotation holds the final state already
        checkpoint_trainer(trainer, args.checkpoint)
        emit("run", f"checkpoint saved to {args.checkpoint}",
             path=args.checkpoint)
    save_logits()
    return 0


if __name__ == "__main__":
    sys.exit(main())
