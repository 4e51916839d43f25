"""``python -m roc_tpu_torch.prewarm`` — pay the first-use cost once
(``roc_tpu/prewarm.py``).

Feeds the program-space enumeration (analysis/programspace.py: every rig
config's step slots and the kernel instances each launches) to the warmer
(utils/prewarm.py): the kernel library is built into the build cache if
it is absent (utils/compile_cache.py), then each program's step runs once
at its real shapes, on the card unless ``--cpu`` is given.

Usage:
    python -m roc_tpu_torch.prewarm                      # every hosted rig
    python -m roc_tpu_torch.prewarm --config sgc_serve   # one rig
    python -m roc_tpu_torch.prewarm --jobs 2             # processes at once
    python -m roc_tpu_torch.prewarm --cpu                # on the CPU

Stdout gets one JSON line per config (its report without the per-slot
rows; a skipped rig's line says ``"skipped": true``); ``#`` diagnostics go
to stderr.  The warm state (``programspace_warm.json`` in the build
cache, or ``--state``) records each warmed config's program keys, which
``python -m roc_tpu_torch.analysis --select compile-explosion --json``
gives for the same rigs.  Exit 1 when a program failed or the cache was
unavailable, 2 for an unknown config.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m roc_tpu_torch.prewarm", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="all",
                    help="rig config name (analysis/programspace.py "
                         "rig_configs) or 'all' (default)")
    ap.add_argument("--cache-dir", default=None,
                    help="the build cache (default: "
                         "$ROC_TPU_TORCH_CACHE_DIR or "
                         "~/.cache/roc_tpu_torch/kernels)")
    ap.add_argument("--state", default=None,
                    help="warm-state file (default: "
                         "programspace_warm.json in the build cache)")
    ap.add_argument("--no-state", action="store_true",
                    help="do not write the warm state")
    ap.add_argument("--jobs", type=int, default=1,
                    help="warm configs in N processes at once; on the card "
                         "they share card 0, and a build one of them "
                         "starts is the others' (the build holds a lock "
                         "in the cache).  Siblings' files landing inside a "
                         "candidate's window count as cold there; the key "
                         "sets stay exact")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain versions: nothing is "
                         "built)")
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap.parse_args(argv)


def _print_report(rep) -> None:
    print(json.dumps({k: v for k, v in rep.items() if k != "slots"}),
          flush=True)


def _parallel(names: List[str], args) -> int:
    """One child process per config, ``--jobs`` at a time; the children
    print their report lines, which are relayed, and the parent writes
    the warm state once."""
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    base = [sys.executable, "-m", "roc_tpu_torch.prewarm", "--no-state",
            "--jobs", "1"]
    if args.cache_dir:
        base += ["--cache-dir", args.cache_dir]
    if args.cpu:
        base.append("--cpu")
    if args.verbose:
        base.append("-v")
    reports, rc = [], 0
    pending, running = list(names), []
    while pending or running:
        while pending and len(running) < max(1, args.jobs):
            name = pending.pop(0)
            running.append((name, subprocess.Popen(
                base + ["--config", name], stdout=subprocess.PIPE,
                stderr=sys.stderr, text=True, env=env)))
        name, proc = running.pop(0)
        out, _ = proc.communicate()
        for line in out.splitlines():
            line = line.strip()
            if line.startswith("{"):
                try:
                    rep = json.loads(line)
                except ValueError:
                    rep = None
                if isinstance(rep, dict) and "keys" in rep:
                    reports.append(rep)
            if line:
                print(line, flush=True)
        if proc.returncode != 0:
            print(f"# prewarm child {name} exited {proc.returncode}",
                  file=sys.stderr)
            rc = 1
    if reports and not args.no_state:
        from .utils.prewarm import write_warm_state
        path = write_warm_state(reports, args.state, args.cache_dir)
        print(f"# warm state -> {path}", file=sys.stderr)
    return rc


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    from .analysis.programspace import rig_configs
    names = sorted(rig_configs()) if args.config == "all" else [args.config]
    unknown = [n for n in names if n not in rig_configs()]
    if unknown:
        print(f"error: unknown config(s) {unknown}; known: "
              f"{sorted(rig_configs())}", file=sys.stderr)
        return 2
    from .train.trainer import resolve_device
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"error: {e} (or --cpu)", file=sys.stderr)
        return 2
    if args.jobs > 1 and len(names) > 1:
        return _parallel(names, args)

    from .analysis.programspace import build_rig_dataset
    from .utils.compile_cache import default_dir
    from .utils.prewarm import prewarm_config, write_warm_state
    # the build cache, as the JAX CLI enables its compile cache
    cache_dir = args.cache_dir or default_dir()
    reports = []
    ds = build_rig_dataset()
    for name in names:
        rep = prewarm_config(name, dataset=ds, cache_dir=cache_dir,
                             verbose=args.verbose, device=device)
        if rep is None:
            print(json.dumps({"config": name, "skipped": True}), flush=True)
            print(f"# prewarm {name}: skipped — the rig needs more ranks "
                  f"than this host runs", file=sys.stderr)
            continue
        reports.append(rep)
        _print_report(rep)
    if reports and not args.no_state:
        try:
            path = write_warm_state(reports, args.state, cache_dir)
            print(f"# warm state -> {path}", file=sys.stderr)
        except OSError as e:
            print(f"# warm state not written: {e}", file=sys.stderr)
            return 1
    if any(r.get("failed") or r.get("cache_unavailable") for r in reports):
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
