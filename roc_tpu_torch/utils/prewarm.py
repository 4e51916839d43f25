"""Prewarm (``roc_tpu/utils/prewarm.py``): pay the first-use cost once,
off the timed path.

The JAX package compiles every program of the program-space enumeration
ahead of time against its persistent cache.  The port has one compiled
artifact, the kernel library in the build cache (utils/compile_cache.py),
and a first step that pays the CUDA start of the kernel instances it
launches.  So warming a candidate of the enumeration
(analysis/programspace.py ``candidate_programs``, the same list the keys
come from) builds the library if it is absent, then runs the candidate's
step once at its real shapes on its device and synchronises.  A train
step runs through ``Trainer.step`` and is undone
(:func:`run_step_restoring`): the parameters, the Adam state, the dropout
generator, the epoch and the objective list are bit-equal to before, so
the next step is the step an unwarmed trainer takes.

Warm or cold is read from the build directory, as the JAX package reads
its cache: a candidate after which files appeared there (a library built)
was cold; none, warm.  A candidate that raises is counted (``failed``)
and its key left out of ``keys``, so the warm state never calls a program
warm that did not run.  With no usable cache directory
(``enable_compile_cache`` returned None) nothing persists for the next
process: every candidate counts cold, no key is recorded and the report
carries ``cache_unavailable``.

With lazy CUDA module loading (``CUDA_MODULE_LOADING=LAZY``, PyTorch's
default) a kernel is loaded into a process at its first launch, so
across processes "warm" means built, not loaded: a new process still
loads each instance at its first launch (chip_smoke.py phase 20 measures
that first launch).  Within a process, a warmed candidate's kernels are
loaded and its allocator's blocks taken.

Entry points: :func:`warm_candidates`, :func:`warm_trainer` (a live
trainer), :func:`prewarm_config` (one rig of the enumeration; ``python -m
roc_tpu_torch.prewarm`` drives it) and the warm state:
:func:`warm_state_path`, :func:`load_warm_state`,
:func:`write_warm_state`.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ..obs.events import emit
from .compile_cache import default_dir, enable_compile_cache

WARM_STATE_NAME = "programspace_warm.json"


def cuda_device_count() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def warm_state_path(path: Optional[str] = None,
                    cache_dir: Optional[str] = None) -> str:
    """The warm-state file: ``path``, else ``programspace_warm.json`` in
    the build cache (``cache_dir``, else the cache's default)."""
    if path:
        return path
    return os.path.join(cache_dir or default_dir(), WARM_STATE_NAME)


def load_warm_state(path: Optional[str] = None,
                    cache_dir: Optional[str] = None) -> Dict[str, Any]:
    """``{config: {"programs": n, "keys": [...], "t": iso}}`` as the
    last prewarm wrote it; a missing or corrupt file is an empty state."""
    try:
        with open(warm_state_path(path, cache_dir)) as f:
            db = json.load(f)
        return db if isinstance(db, dict) else {}
    except (OSError, ValueError):
        return {}


def write_warm_state(reports: List[Dict[str, Any]],
                     path: Optional[str] = None,
                     cache_dir: Optional[str] = None) -> str:
    """Merge per-config reports (``config``, ``keys``) into the warm
    state; returns its path."""
    p = warm_state_path(path, cache_dir)
    state = load_warm_state(p)
    now = time.strftime("%Y-%m-%dT%H:%M:%S%z")
    for rep in reports:
        state[rep["config"]] = {"programs": len(rep.get("keys", [])),
                                "keys": sorted(rep.get("keys", [])),
                                "t": now}
    os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
    tmp = p + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f, indent=1, sort_keys=True)
    os.replace(tmp, p)
    return p


def cache_dir_for(cache_dir: Optional[str] = None) -> Optional[str]:
    """The build directory a warm runs against: ``cache_dir`` made the
    build cache (``enable_compile_cache``; None when it cannot be
    created), or with None the directory the kernels build in now (the
    in-tree default unless the cache was enabled)."""
    if cache_dir:
        return enable_compile_cache(cache_dir)
    from ..kernels import _build
    try:
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
    except OSError:
        return None
    return _build.BUILD_DIR


def _cache_entries(cache_dir: Optional[str]) -> set:
    """The build directory's files (its lock file aside)."""
    if not cache_dir:
        return set()
    try:
        return {n for n in os.listdir(cache_dir) if not n.startswith(".")}
    except OSError:
        return set()


def _ensure_library(device) -> None:
    """Build (or load) the kernel library when ``device`` is a card, in
    the build directory in use: a library this process loaded from
    another directory does not make this one warm."""
    if device is not None and getattr(device, "type", "cpu") == "cuda":
        from ..kernels import _build
        if not os.path.exists(_build.library_path()):
            _build.reset()
        _build.library()


def _sync(device) -> None:
    if device is not None and getattr(device, "type", "cpu") == "cuda":
        import torch
        torch.cuda.synchronize(device)


def run_step_restoring(tr, slot: str, record=None) -> Any:
    """Run ``tr``'s step slot once ('train_step' through ``Trainer.step``
    at the config's learning rate, 'eval_step' through
    ``Trainer.evaluate``), synchronised, and put back what a train step
    moves: the params and Adam moments (copied back in place, so they
    stay the same tensors), the Adam counters, the dropout generator's
    state, the epoch, the objective list and the streamed head's span
    and staging records.  On a partitioned trainer every rank calls it
    together (the step's collectives).  ``record``: a callable that runs
    the slot's device work for it (analysis/step_trace.py ``record``:
    ``Trainer.step``, or ``Trainer.eval_sums`` without the eval's host
    fetch); returns what it returned."""
    import torch
    if slot == "eval_step":
        got = tr.evaluate() if record is None else record(tr.eval_sums)
        tr.sync()
        return got
    if slot != "train_step":
        raise ValueError(f"unknown step slot {slot!r}")
    st = tr.opt_state
    with torch.no_grad():
        params = {k: v.detach().clone() for k, v in tr.params.items()}
        m = {k: v.clone() for k, v in st.m.items()}
        v_ = {k: v.clone() for k, v in st.v.items()}
    gen = tr.generator.get_state().clone()
    epoch, n_losses = tr.epoch, len(tr.losses)
    spans = {k: list(v) for k, v in tr.spans_ms.items()}
    lr = float(tr.config.learning_rate)
    try:
        got = (tr.step(lr) if record is None
               else record(lambda: tr.step(lr)))
        tr.sync()
    finally:
        with torch.no_grad():
            for k, w in tr.params.items():
                w.copy_(params[k])
            for k in st.m:
                st.m[k].copy_(m[k])
                st.v[k].copy_(v_[k])
        tr.opt_state = st
        tr.generator.set_state(gen)
        tr.epoch = epoch
        del tr.losses[n_losses:]
        tr.spans_ms = spans
        head = getattr(tr, "_head", None)
        if head is not None:
            # the warm step's staging figures are no step's
            head.pool.take_stats()
    return got


def warm_candidates(cands, cache_dir: Optional[str],
                    config: str = "trainer", verbose: bool = False,
                    device=None) -> Dict[str, Any]:
    """Run every candidate once against the build cache ``cache_dir``
    (module docstring) on ``device`` (the card's library is built first
    when absent).  Per candidate a ``compile`` event and a ``slots`` row:
    its seconds (``run_s``; ``library_s`` of them the library's build or
    load), ``cold`` and the files that appeared, the instances it
    launched (``launched``) and whether they equal the enumerated ones
    (``instances_match``).  A
    failed candidate is counted and left out of ``keys``."""
    from ..kernels import _build
    cands = list(cands)
    cache_ok = bool(cache_dir) and os.path.isdir(cache_dir)
    if not cache_ok:
        emit("compile", f"prewarm {config}: build cache UNAVAILABLE "
             f"(dir={cache_dir!r}) — nothing persists, nothing is warmed "
             f"for later processes", console=True, prewarm=config,
             cache_unavailable=True)
    warm = cold = failed = 0
    library_s = 0.0
    t_start = time.perf_counter()
    slots: List[Dict[str, Any]] = []
    keys: List[str] = []
    for c in cands:
        before = _cache_entries(cache_dir)
        inst0 = _build.instances_launched()
        t0 = time.perf_counter()
        try:
            _ensure_library(device)
            lib_s = time.perf_counter() - t0
            c.run()
            _sync(device)
        # a candidate that fails is reported and skipped; the warmer
        # goes on with the others (the JAX package's contract)
        except Exception as e:  # noqa: BLE001 - degrade, not die
            failed += 1
            emit("compile", f"prewarm {config}:{c.slot} FAILED: "
                 f"{type(e).__name__}: {e}", console=verbose,
                 prewarm=config, slot=c.slot, error=str(e)[:200])
            continue
        dt = time.perf_counter() - t0
        if cache_ok:
            keys.append(c.key)
        new = sorted(_cache_entries(cache_dir) - before)
        is_cold = bool(new) or not cache_ok
        cold += is_cold
        warm += not is_cold
        launched = _build.instances_since(inst0)
        library_s += lib_s
        row = {"slot": c.slot, "run_s": round(dt, 4),
               "library_s": round(lib_s, 4), "cold": is_cold,
               "new_files": new, "instances": sorted(c.instances),
               "launched": launched,
               "instances_match": launched == sorted(c.instances)}
        slots.append(row)
        emit("compile", f"prewarm {config}:{c.slot}: {dt:.3f}s "
             f"({'cold' if is_cold else 'warm hit'})", console=verbose,
             prewarm=config, **row)
    out = {"config": config, "programs": len(cands),
           "compile_warm_hits": warm, "compile_cold": cold,
           "failed": failed,
           "prewarm_s": round(time.perf_counter() - t_start, 3),
           "library_s": round(library_s, 3),
           "cache_dir": cache_dir, "slots": slots, "keys": keys,
           "instances_match": all(r["instances_match"] for r in slots)}
    if not cache_ok:
        out["cache_unavailable"] = True
    emit("compile", f"prewarm {config}: {out['programs']} programs, "
         f"{warm} warm / {cold} cold"
         + (f" / {failed} failed" if failed else "")
         + f" in {out['prewarm_s']}s", prewarm=config, summary=True,
         programs=out["programs"], compile_warm_hits=warm,
         compile_cold=cold, failed=failed, prewarm_s=out["prewarm_s"])
    return out


def warm_trainer(tr, cache_dir: Optional[str] = None,
                 name: str = "trainer", verbose: bool = False,
                 device_kind: Optional[str] = None) -> Dict[str, Any]:
    """Warm a live trainer's programs (its train and eval steps) against
    the build cache ``cache_dir`` (None: the build directory in use,
    :func:`cache_dir_for`), leaving the trainer bit-equal
    (:func:`run_step_restoring`)."""
    from ..analysis.programspace import candidate_programs
    d = cache_dir_for(cache_dir)
    return warm_candidates(candidate_programs(tr, device_kind), d,
                           config=name, verbose=verbose, device=tr.device)


def prewarm_config(name: str, dataset=None, cache_dir: Optional[str] = None,
                   verbose: bool = False, device=None
                   ) -> Optional[Dict[str, Any]]:
    """Warm one rig of the enumeration (analysis/programspace.py
    ``rig_configs``) on ``device`` (the card unless the caller passes
    another) against the build cache ``cache_dir`` (None: the build
    directory in use): the kernel library built or loaded first
    (``library_cold``, ``library_files``: whether files appeared; its
    seconds join ``library_s``), then its trainer or predictor built and
    each candidate run once.
    A partitioned rig runs its ranks here (``run_ranks``, gloo; on the
    card every rank takes card 0) and reports rank 0's record.  Returns
    None, with a ``skipped`` event, for a rig of more ranks than the host
    runs (``host_ranks``)."""
    from ..analysis.programspace import (build_rig_dataset,
                                         build_rig_trainer,
                                         candidate_programs, host_ranks,
                                         rig_configs, rig_required_devices)
    from ..train.trainer import resolve_device
    device = resolve_device(device)
    spec = rig_configs()[name]
    needed, have = rig_required_devices(spec), host_ranks(device)
    if needed > have:
        emit("compile", f"prewarm {name}: skipped (needs {needed} ranks, "
             f"the host runs {have})", console=verbose, prewarm=name,
             skipped=True, needed=needed, have=have)
        return None
    d = cache_dir_for(cache_dir)
    # the library first: a rig's build may launch kernels itself (a
    # serve rig's propagation), and its build is the config's, counted
    # apart from the programs
    before = _cache_entries(d)
    t0 = time.perf_counter()
    _ensure_library(device)
    lib = {"library_s": round(time.perf_counter() - t0, 3),
           "library_files": sorted(_cache_entries(d) - before)}
    lib["library_cold"] = bool(lib["library_files"])
    if spec.parts > 1:
        from ..parallel.distributed import run_ranks
        rep = run_ranks(prewarm_rank_job, needed, name=name, cache_dir=d,
                        device=str(device.type))[0]
    else:
        ds = dataset if dataset is not None else build_rig_dataset()
        tr = build_rig_trainer(spec, ds, device)
        rep = warm_candidates(candidate_programs(tr), d, config=name,
                              verbose=verbose, device=device)
    rep["library_s"] = round(rep["library_s"] + lib["library_s"], 3)
    rep.update(library_cold=lib["library_cold"],
               library_files=lib["library_files"])
    return rep


def prewarm_rank_job(name: str, cache_dir: Optional[str],
                     device: str = "cuda") -> Dict[str, Any]:
    """One rank of a partitioned rig's prewarm (:func:`prewarm_config`):
    the rank's trainer on ``device`` (card 0 on the card), its candidates
    run together with the other ranks', against the build directory
    ``cache_dir`` (None: the cache was unavailable; the in-tree one)."""
    from ..analysis.programspace import (build_rig_trainer,
                                         candidate_programs, rig_configs)
    from ..train.trainer import resolve_device
    dev = resolve_device("cuda:0" if device == "cuda" else device)
    if dev.type == "cuda":
        import torch
        torch.cuda.set_device(dev)
    d = cache_dir_for(cache_dir) if cache_dir else None
    tr = build_rig_trainer(rig_configs()[name], device=dev)
    return warm_candidates(candidate_programs(tr), d, config=name,
                           device=dev)
