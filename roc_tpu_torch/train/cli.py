"""Command-line training driver, the subset of ``roc_tpu/train/cli.py``
that the port covers: the reference's flags (``gnn.cc:114-179``) —
``-lr``, ``-e/-epoch``, ``-dropout/-dr``, ``-decay/-wd``, ``-decay-rate``,
``-decay-step/-ds``, ``-file``, ``-layers`` (dash-separated, e.g.
``602-256-41``: input width, hidden widths, classes), ``-seed``,
``-verbose/-v`` — and ``--impl``, ``--fuse``, ``--dtype``,
``--eval-every``, ``--parts``, ``--dist-backend``, ``--cpu``.  ``--impl``
takes the ported counterparts of the JAX CLI's choices: ``cuda`` (its
``pallas``, the default), ``ell`` and ``segment``; ``--dtype`` its
``float32``, ``bfloat16`` and ``mixed`` (train/trainer.py
``resolve_dtypes``).

Runs on the card unless ``--cpu`` is given; without a card and without
``--cpu`` it exits with an error.  Without ``-file`` it trains on a
synthetic dataset (512 vertices, degree 8).  Prints the reference's
``[INFER]`` line at every eval (rank 0 only).

``--parts 1`` (the default) trains on one device (``Trainer``);
``--parts N`` trains N partitions, one per rank of a process group
(parallel/distributed.py ``DistributedTrainer``).  The ranks come from
``torchrun``, whose environment gives the rank and world size (which
must equal N); rank r takes card ``cuda:<local rank>``.  The backend is
``nccl`` on the card and ``gloo`` with ``--cpu``; ``--dist-backend``
overrides it.

    python -m roc_tpu_torch.train.cli -layers 16-16-4 -e 50 -v
    python -m roc_tpu_torch.train.cli --cpu -layers 16-16-4 -e 20 -v
    python -m roc_tpu_torch.train.cli -layers 16-16-4 -e 50 --dtype mixed
    torchrun --standalone --nproc-per-node 2 -m roc_tpu_torch.train.cli \
        --parts 2 --cpu -layers 16-16-4 -e 20
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

from .trainer import DTYPE_MODES

# the JAX CLI's --impl choices that have a ported route, by port name
IMPLS = ("cuda", "ell", "segment")
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
    ap.add_argument("--impl", default="cuda", choices=IMPLS,
                    help="aggregation route: cuda = the hand-written "
                         "kernels (K1 -> K4 -> K2), ell / segment = the "
                         "plain PyTorch sums")
    ap.add_argument("--fuse", default="auto", choices=["auto", "on", "off"],
                    help="fold norm -> aggregate -> norm [-> relu] chains "
                         "into one fused aggregation op")
    ap.add_argument("--dtype", default="float32", choices=DTYPE_MODES,
                    help="float32 = the reference's pure-fp32 "
                         "semantics; bfloat16 = everything (incl. "
                         "params) in bf16; mixed = fp32 master params "
                         "+ bf16 features/activations/aggregation (the "
                         "kernels' bf16 instances)")
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--parts", type=int, default=1,
                    help="graph partitions, one per rank (launch N > 1 "
                         "ranks with torchrun --nproc-per-node N)")
    ap.add_argument("--dist-backend", default=None, choices=DIST_BACKENDS,
                    help="torch.distributed backend for --parts > 1 "
                         "(default: nccl on the card, gloo with --cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernel route then runs the "
                         "kernels' plain versions)")
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
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world != args.parts:
        print(f"error: --parts {args.parts} but the launcher started "
              f"{world} rank(s) (torchrun --nproc-per-node {args.parts})",
              file=sys.stderr)
        return 2
    from .trainer import resolve_device
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"error: {e} (or --cpu)", file=sys.stderr)
        return 2
    rank = 0
    if args.parts > 1:
        import torch
        import torch.distributed as dist
        backend = args.dist_backend or ("gloo" if args.cpu else "nccl")
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
        dist.init_process_group(backend)
        rank = dist.get_rank()
    try:
        return _train(args, layers, device, rank)
    finally:
        if args.parts > 1:
            dist.destroy_process_group()


def _train(args, layers, device, rank) -> int:
    from ..core.graph import load_dataset, synthetic_dataset
    from ..models.gcn import build_gcn
    from ..ops.dense import set_fp32_matmul_precision
    from .trainer import TrainConfig, Trainer, resolve_dtypes
    set_fp32_matmul_precision()
    if args.file:
        ds = load_dataset(args.file, in_dim=layers[0],
                          num_classes=layers[-1])
    else:
        ds = synthetic_dataset(512, 8, in_dim=layers[0],
                               num_classes=layers[-1], seed=args.seed)
    verbose = args.verbose and rank == 0
    if verbose:
        print(f"# dataset={ds.name} V={ds.graph.num_nodes} "
              f"E={ds.graph.num_edges} layers={layers} lr={args.lr} "
              f"wd={args.weight_decay} dropout={args.dropout} "
              f"decay={args.decay_rate}/{args.decay_steps} "
              f"impl={args.impl} fuse={args.fuse} dtype={args.dtype} "
              f"parts={args.parts} device={device}",
              file=sys.stderr)
    dtype, compute_dtype = resolve_dtypes(args.dtype)
    cfg = TrainConfig(
        learning_rate=args.lr, weight_decay=args.weight_decay,
        dropout_rate=args.dropout, decay_rate=args.decay_rate,
        decay_steps=args.decay_steps, epochs=args.epochs, seed=args.seed,
        eval_every=args.eval_every, verbose=True, aggr_impl=args.impl,
        aggr_fuse=args.fuse, dtype=dtype, compute_dtype=compute_dtype)
    model = build_gcn(layers, dropout_rate=args.dropout)
    if args.parts > 1:
        from ..parallel.distributed import DistributedTrainer
        trainer = DistributedTrainer(model, ds, args.parts, cfg,
                                     device=device)
    else:
        trainer = Trainer(model, ds, cfg, device=device)
    t0 = time.perf_counter()
    trainer.train()
    trainer.sync()
    if verbose:
        dt = time.perf_counter() - t0
        print(f"# {args.epochs} epochs in {dt:.1f}s "
              f"({1000.0 * dt / max(args.epochs, 1):.1f} ms/epoch)",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
