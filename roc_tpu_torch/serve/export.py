"""Building, exporting and loading predictors (``roc_tpu/serve/
export.py``): ``python -m roc_tpu_torch.export``.

- :func:`build_predictor` resolves the model and config through the
  trainer's resolve pass (train/trainer.py ``resolve_config``: fuse,
  then the attention route), picks the backend
  (:func:`resolve_backend`) and, for the precomputed backend, computes
  its table on the card: the propagation prefix through the route's
  kernels ('akx'), or the eval forward once ('table').
- :func:`export_predictor` writes an artifact: ``params.npz`` (int8/fp8
  weights with ``::scale`` companions when quantized),
  ``propagation.npz`` (precomputed backend) and ``serve_manifest.json``
  v1 (the resolved model spec, the config, the params fingerprint and
  the quant block).  A quantized export runs the drift gate before any
  file is written.
- ``--shards N`` (``export_predictor(shards=N)``) also writes N table
  slices, ``propagation_shard{k}.npz`` (:func:`make_shard_slices`), and
  the manifest's ``shards`` block; ``load_predictor(shard=k)`` loads one
  slice, which serves the global ids through the cross-shard gather
  (serve/predictor.py, serve/router.py).
- :func:`load_predictor` rebuilds a predictor from an artifact written
  by this package or by the JAX package.  The JAX manifest's
  compile-cache fields (``program_keys``, ``prewarm``) have no meaning
  for eager PyTorch and are ignored; its route names map to the port's
  (``pallas`` -> ``cuda``, ``pallas_csr`` -> ``cuda_csr``), and a
  full-backend artifact on a layout the port lacks raises
  ``NotImplementedError``.  This package writes no program keys, so the
  JAX loader refuses its artifacts.

Every entry point runs on the card unless the caller passes a device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.events import emit
from ..train.trainer import (LAYOUT_FIELDS, layout_options,
                             make_graph_context,
                             resolve_config, resolve_device,
                             resolve_symmetric)
from .predictor import SERVE_BUCKETS, Predictor, ShardSlice
from .propagation import (PropagationCache, logits_table_cache,
                          prefix_descriptors)

MANIFEST_NAME = "serve_manifest.json"
MANIFEST_VERSION = 1

SHARD_FILE = "propagation_shard{k}.npz"


def resolve_backend(model, backend: str) -> Tuple[str, Optional[str]]:
    """``(backend, flavor)``: 'auto' picks 'precomputed' (flavor 'akx')
    when the model has a parameter-free propagation prefix (the SGC
    family), else 'full'; an explicit 'precomputed' on a model without
    one means the frozen-logits flavor 'table'."""
    has_split = model.precompute_split() is not None
    if backend == "auto":
        return ("precomputed", "akx") if has_split else ("full", None)
    if backend == "precomputed":
        return ("precomputed", "akx" if has_split else "table")
    if backend == "full":
        return ("full", None)
    raise ValueError(f"unknown serve backend {backend!r}; expected "
                     "'auto', 'precomputed', or 'full'")


def _num_classes(model) -> Optional[int]:
    dims = [op.dim for op in model._ops if op.kind == "linear"]
    return dims[-1] if dims else None


def _graph_context(model, dataset, config, device):
    """The trainer's graph context of a resolved ``(model, config)``: the
    same route, tables and baked normalization (Trainer._place), with
    the head unchunked (``head_chunk`` 0), as the JAX package's export
    builds it."""
    return make_graph_context(dataset, config.aggr_impl,
                              symmetric=config.symmetric, device=device,
                              chunk=config.chunk,
                              fuse=model.num_fused_aggregates() > 0,
                              **layout_options(config))


def _full_logits_host(model, dataset, config, params,
                      device) -> np.ndarray:
    """The 'table' flavor's precompute: the eval forward once, on
    ``device`` through the config's route, as fp32 host logits.  Its
    graph context is dropped on return."""
    from ..train.trainer import cast_floats, compute_dtype_of
    compute = compute_dtype_of(config)
    gctx = _graph_context(model, dataset, config, device)
    feats = torch.as_tensor(np.asarray(dataset.features),
                            dtype=compute).to(device)
    with torch.inference_mode():
        logits = model.apply(cast_floats(
            {k: v.detach().to(device) for k, v in params.items()},
            compute), feats, gctx, train=False)
        # export: the forward's logits, written to the artifact
        # roc-lint: ok=host-sync-hot-path
        return logits.to(torch.float32).cpu().numpy()


def build_predictor(model, dataset, config, params=None,
                    backend: str = "auto",
                    buckets: Sequence[int] = SERVE_BUCKETS,
                    cache: Optional[PropagationCache] = None,
                    quant: str = "off", device=None,
                    verbose: bool = False) -> Predictor:
    """Resolve the model and config (``resolve_config``, as ``Trainer``
    does) and build a live Predictor on ``device`` (the card unless the
    caller passes another; with no card and no ``device`` it raises).
    ``params=None`` draws fresh Glorot weights from a generator seeded
    with ``config.seed``; ``cache`` skips the precompute (the artifact
    loader passes the stored one); ``quant`` picks the table encoding
    (serve/quant.py; the drift gate is :func:`export_predictor`'s)."""
    device = resolve_device(device)
    model, config = resolve_config(model, dataset, config, device=device)
    config = dataclasses.replace(
        config, symmetric=resolve_symmetric(dataset, config.symmetric))
    if params is None:
        gen = torch.Generator(device=device).manual_seed(config.seed)
        params = model.init_params(gen, dtype=config.dtype, device=device)
    backend, flavor = resolve_backend(model, backend)
    head_model = gctx = None
    if backend == "precomputed":
        if flavor == "akx":
            prefix_ops, head_model = model.precompute_split()
            if cache is None:
                cache = PropagationCache.build(
                    dataset.graph, prefix_descriptors(prefix_ops),
                    np.asarray(dataset.features), device=device)
        elif cache is None:
            cache = logits_table_cache(_full_logits_host(
                model, dataset, config, params, device))
    else:
        gctx = _graph_context(model, dataset, config, device)
    emit("serve", f"predictor: backend={backend}"
         + (f"/{flavor}" if flavor else "")
         + f" buckets={tuple(sorted(buckets))} V={dataset.graph.num_nodes}",
         console=verbose, kind="build", backend=backend, flavor=flavor)
    return Predictor(model, config, params, backend, buckets,
                     cache=cache, head_model=head_model, flavor=flavor,
                     dataset=dataset if backend == "full" else None,
                     gctx=gctx, num_classes=_num_classes(model),
                     quant=quant, device=device)


# ------------------------------------------------------- sharded slices

def make_shard_slices(cache: PropagationCache, num_shards: int,
                      buckets: Sequence[int],
                      quant: str = "off") -> List[ShardSlice]:
    """The export's shard plan: contiguous ``[lo, hi)`` ranges from the
    trainer's edge-balanced sweep (``core/partition.py
    edge_balanced_bounds``) in one fleet-uniform layout: ``rows_padded``
    the largest range rounded up to ``NODE_MULTIPLE``, ``halo`` the
    largest bucket.  Quantized slices are cut from the full table's codes
    and scales and carry its largest scale.  A cache that holds no edges
    (the 'table' flavor's logits) is split by rows: each row weighs one
    edge, where an edge-weighted sweep would put every row in the first
    range."""
    from ..core.partition import NODE_MULTIPLE, edge_balanced_bounds
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    V = cache.num_nodes
    weights = (cache.row_ptr if cache.row_ptr[-1] > 0
               else np.arange(V + 1, dtype=np.int64))
    plan: List[Tuple[int, int]] = []
    for left, right in edge_balanced_bounds(weights, num_shards):
        plan.append((int(left), int(right) + 1) if right >= left
                    else (V, V))
    own_max = max(hi - lo for lo, hi in plan)
    rows_padded = -(-max(own_max, 1) // NODE_MULTIPLE) * NODE_MULTIPLE
    halo = max(int(b) for b in buckets)
    if quant != "off":
        from .quant import quantize_rows
        q, sc = quantize_rows(cache.table, quant)
        guard = float(sc.max())
        return [ShardSlice(lo, hi, V, rows_padded, halo, codes=q[lo:hi],
                           scales=sc[lo:hi], scale_guard=guard)
                for lo, hi in plan]
    return [ShardSlice(lo, hi, V, rows_padded, halo,
                       rows=cache.table[lo:hi]) for lo, hi in plan]


def _write_shard_slice(out_dir: str, k: int, sl: ShardSlice,
                       quant: str) -> str:
    """``propagation_shard{k}.npz`` with the JAX package's members,
    written to a temporary file and renamed into place."""
    import tempfile
    data: Dict[str, Any] = {
        "lo": np.int64(sl.lo), "hi": np.int64(sl.hi),
        "num_nodes": np.int64(sl.num_nodes),
        "rows_padded": np.int64(sl.rows_padded),
        "halo": np.int64(sl.halo)}
    if quant != "off":
        from .quant import to_storage_bytes
        data["rows_q"] = to_storage_bytes(sl.codes)
        data["rows_scale"] = sl.scales
        data["scale_guard"] = np.float64(sl.scale_guard)
    else:
        data["rows"] = sl.rows
    path = os.path.join(out_dir, SHARD_FILE.format(k=k))
    fd, tmp = tempfile.mkstemp(dir=out_dir, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_shard_slice(artifact_dir: str, k: int,
                     quant: str = "off") -> ShardSlice:
    """One stored table slice (this package's or the JAX package's) as a
    :class:`ShardSlice`; quantized codes come back from their bytes."""
    path = os.path.join(artifact_dir, SHARD_FILE.format(k=k))
    with np.load(path) as z:
        lo, hi = int(z["lo"]), int(z["hi"])
        num_nodes = int(z["num_nodes"])
        rows_padded, halo = int(z["rows_padded"]), int(z["halo"])
        if quant != "off":
            from .quant import from_storage_bytes
            return ShardSlice(
                lo, hi, num_nodes, rows_padded, halo,
                codes=from_storage_bytes(z["rows_q"], quant),
                scales=np.asarray(z["rows_scale"], dtype=np.float32),
                scale_guard=float(z["scale_guard"]))
        return ShardSlice(lo, hi, num_nodes, rows_padded, halo,
                          rows=np.asarray(z["rows"], dtype=np.float32))


def _shard_block(pred: Predictor, out_dir: str,
                 shards: int) -> Dict[str, Any]:
    """Write ``pred``'s table slices; returns the manifest's ``shards``
    block (the plan, the shared layout, the files, and the bytes a
    replica holds beside the full table's)."""
    from .quant import table_bytes
    slices = make_shard_slices(pred.cache, shards, pred.buckets, pred.quant)
    files = [os.path.basename(_write_shard_slice(out_dir, k, sl,
                                                 pred.quant))
             for k, sl in enumerate(slices)]
    F = int(pred.cache.table.shape[1])
    return {"n": int(shards),
            "plan": [[int(sl.lo), int(sl.hi)] for sl in slices],
            "rows_padded": int(slices[0].rows_padded),
            "halo": int(slices[0].halo),
            "files": files,
            "bytes_per_replica": int(table_bytes(
                (slices[0].rows_padded + slices[0].halo + 1, F),
                pred.quant)),
            "bytes_full": int(table_bytes((pred.num_nodes + 1, F),
                                          pred.quant))}


# ------------------------------------------------------------ artifact

def _host_params(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host arrays for ``params.npz``: fp32 as is, bf16 as its 2-byte
    words (``|V2``, how numpy stores the JAX package's bf16)."""
    from ..utils.checkpoint import _tensor_to_numpy
    # export: the params, written to params.npz
    # roc-lint: ok=host-sync-hot-path
    return {k: _tensor_to_numpy(v.detach().cpu()) for k, v in params.items()}


def _params_from_host(raw: Dict[str, np.ndarray], dtype: torch.dtype,
                      device) -> Dict[str, torch.Tensor]:
    from ..utils.checkpoint import _to_tensor, dtype_name
    out = {}
    for k, v in raw.items():
        v = np.asarray(v)
        if v.dtype.itemsize == 2 and (v.dtype.kind == "V"
                                      or v.dtype.name == "bfloat16"):
            t = _to_tensor(v.view(np.uint16), dtype_name(torch.bfloat16))
        else:
            t = torch.from_numpy(np.array(v, copy=True))
        out[k] = t.to(device=device, dtype=dtype)
    return out


def _quant_ref_logits(pred: Predictor, params, sample) -> np.ndarray:
    """The fp32 half of the drift gate: fp32 table rows through the
    head with the unquantized params."""
    rows = pred.cache.table[sample]
    if pred.flavor == "table":
        return np.asarray(rows, dtype=np.float32)
    x = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.float32)).to(
        pred.device, pred.compute)
    with torch.inference_mode():
        out = pred.head_model.apply(params, x, None, train=False)
    # export's drift gate: the fp32 reference logits
    # roc-lint: ok=host-sync-hot-path
    return out.to(torch.float32).cpu().numpy()


def _config_block(cfg) -> Dict[str, Any]:
    """The manifest's ``config``, in the JAX package's names: numpy
    dtype names and the JAX route name."""
    from ..convert import aggr_impl_to_jax
    from ..utils.checkpoint import dtype_name
    return {"dtype": dtype_name(cfg.dtype),
            "compute_dtype": (None if cfg.compute_dtype is None
                              else dtype_name(cfg.compute_dtype)),
            "aggr_impl": aggr_impl_to_jax(cfg.aggr_impl),
            "chunk": cfg.chunk, "symmetric": bool(cfg.symmetric),
            **layout_options(cfg)}


def export_predictor(pred: Predictor, out_dir: str,
                     dataset_meta: Optional[Dict[str, Any]] = None,
                     drift_argmax_min: Optional[float] = None,
                     drift_dlogit_max: Optional[float] = None,
                     shards: int = 0) -> Dict[str, Any]:
    """Persist ``pred`` as a serving artifact in ``out_dir``; returns
    the manifest.  ``shards`` > 0 also writes that many table slices
    (precomputed backend only).  A quantized predictor first runs the drift gate
    (argmax agreement and relative max |Δlogit| against the fp32
    reference on a held-out sample, thresholds from serve/quant.py
    unless given) and raises ``QuantDriftError`` before any file is
    written; the predictor then serves with the params' quantization
    round trip, the values a cold load reconstructs."""
    from ..utils.checkpoint import params_signature
    from .quant import QuantSpec
    host_params = _host_params(pred.master_params)
    qblock: Dict[str, Any] = {"spec": QuantSpec(pred.quant).to_json()}
    store_params = host_params
    if pred.quant != "off":
        from .quant import (drift_report, drift_sample, quantize_params,
                            require_drift_ok, row_scales, scale_stats)
        params_orig = pred.params
        store_params, roundtrip, qkeys = quantize_params(host_params,
                                                         pred.quant)
        pred.set_params(_params_from_host(roundtrip, pred.config.dtype,
                                          pred.device))
        sample = drift_sample(pred.num_nodes)
        drift = drift_report(
            _quant_ref_logits(pred, params_orig, sample),
            pred.query(sample),
            **{k: v for k, v in (("argmax_min", drift_argmax_min),
                                 ("dlogit_max", drift_dlogit_max))
               if v is not None})
        qblock["drift"] = drift
        qblock["params"] = {"quantized": qkeys, "scale_suffix": "::scale"}
        qblock["scale_stats"] = [scale_stats(row_scales(s, pred.quant))
                                 for s in pred.cache.stages]
        require_drift_ok(drift, f"export to {out_dir}")
    if pred.cache is not None:
        from .quant import table_bytes
        shapes = [s.shape for s in pred.cache.stages]
        b_fp32 = sum(table_bytes(s, "off") for s in shapes)
        b_mode = sum(table_bytes(s, pred.quant) for s in shapes)
        qblock["table"] = {"stages": len(shapes), "bytes_fp32": int(b_fp32),
                           "bytes": int(b_mode),
                           "shrink": round(b_fp32 / max(b_mode, 1), 2)}
    if shards and (pred.backend != "precomputed" or pred.cache is None):
        raise ValueError("sharded export applies to the precomputed "
                         "table backend")
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, "params.npz"), **store_params)
    if pred.cache is not None:
        pred.cache.save(os.path.join(out_dir, "propagation.npz"),
                        quant=pred.quant)
    shard_block = _shard_block(pred, out_dir, shards) if shards else None
    cfg = pred.config
    block = _config_block(cfg)
    meta = dict(dataset_meta or {})
    manifest: Dict[str, Any] = {
        "version": MANIFEST_VERSION,
        "backend": pred.backend,
        "flavor": pred.flavor,
        "buckets": list(pred.buckets),
        "model": pred.model.to_spec(),
        "num_classes": pred.num_classes,
        "config": block,
        "fingerprint": {"params_sig": params_signature(pred.master_params),
                        "dtype": block["dtype"],
                        "compute_dtype": block["compute_dtype"],
                        "dataset": meta},
        "dataset": meta,
        "num_nodes": pred.num_nodes,
        "quant": qblock,
        "shards": shard_block,
        "created": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    path = os.path.join(out_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    emit("serve", f"artifact exported to {out_dir}: {pred.backend}"
         + (f"/{pred.flavor}" if pred.flavor else ""),
         kind="export", path=out_dir, backend=pred.backend)
    return manifest


def export_trainer(trainer, dataset, out_dir: str, backend: str = "auto",
                   buckets: Sequence[int] = SERVE_BUCKETS,
                   quant: str = "off", device=None) -> Dict[str, Any]:
    """Export a live trainer's weights (``Trainer`` or
    ``DistributedTrainer``) as a serving artifact; the predictor is
    built on ``device`` (the card unless the caller passes another).
    The trainer's model and config are resolved already, and the
    resolve pass is idempotent."""
    pred = build_predictor(trainer.model, dataset, trainer.config,
                           params=trainer.params, backend=backend,
                           buckets=buckets, quant=quant, device=device)
    meta = {"V": int(dataset.graph.num_nodes),
            "E": int(dataset.graph.num_edges),
            "name": getattr(dataset, "name", None)}
    return export_predictor(pred, out_dir, dataset_meta=meta)


def _route_from_manifest(impl: str, backend: str) -> str:
    from ..convert import AGGR_IMPL_FROM_JAX
    if impl in AGGR_IMPL_FROM_JAX:
        return AGGR_IMPL_FROM_JAX[impl]
    if backend == "full":
        raise NotImplementedError(
            f"the artifact serves the full backend on the JAX layout "
            f"{impl!r}, which is not ported (ported: "
            f"{sorted(AGGR_IMPL_FROM_JAX)})")
    # a precomputed artifact runs no graph op: the route is unused
    return "cuda"


def load_predictor(artifact_dir: str, dataset=None, device=None,
                   verbose: bool = False,
                   shard: Optional[int] = None) -> Predictor:
    """Rebuild a Predictor from an artifact (this package's or the JAX
    package's) on ``device`` (the card unless the caller passes
    another).  No resolve pass runs: the manifest carries the resolved
    op list and config.  ``dataset`` is needed by the full backend only
    (a precomputed artifact holds its table).  ``shard=k`` loads table
    slice k of an artifact exported with ``--shards`` (its rows and the
    halo, not the table); it answers foreign ids once the caller wires
    ``pred.gather_fn``."""
    from ..models.builder import Model
    from ..train.trainer import TrainConfig
    from ..utils.checkpoint import params_signature
    device = resolve_device(device)
    with open(os.path.join(artifact_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest.get("version") != MANIFEST_VERSION:
        raise ValueError(f"{artifact_dir}: manifest version "
                         f"{manifest.get('version')} != {MANIFEST_VERSION}")
    model = Model.from_spec(manifest["model"])
    backend, flavor = manifest["backend"], manifest.get("flavor")
    mc = manifest["config"]
    config = TrainConfig(
        verbose=verbose, aggr_fuse="off",
        dtype=getattr(torch, mc["dtype"]),
        compute_dtype=(None if mc.get("compute_dtype") is None
                       else getattr(torch, mc["compute_dtype"])),
        aggr_impl=_route_from_manifest(mc["aggr_impl"], backend),
        chunk=int(mc.get("chunk", 512)), symmetric=mc.get("symmetric"),
        **{k: mc[k] for k in LAYOUT_FIELDS if k in mc})
    qmode = ((manifest.get("quant") or {}).get("spec")
             or {}).get("mode", "off")
    with np.load(os.path.join(artifact_dir, "params.npz")) as z:
        raw = {k: np.asarray(z[k]) for k in z.files}
    if qmode != "off":
        from .quant import dequantize_params
        raw = dequantize_params(raw, qmode)
    params = _params_from_host(raw, config.dtype, device)
    sig = params_signature(params)
    want = (manifest.get("fingerprint") or {}).get("params_sig")
    if want and sig != want:
        raise ValueError(
            f"{artifact_dir}: params fingerprint mismatch ({sig} != "
            f"manifest {want}) — params.npz does not belong to this "
            f"manifest")
    cache = head_model = gctx = slice_ = None
    if shard is not None:
        sb = manifest.get("shards")
        if not sb:
            raise ValueError(f"{artifact_dir}: shard={shard} requested but "
                             f"the artifact was not exported with --shards")
        if not 0 <= int(shard) < int(sb["n"]):
            raise ValueError(f"{artifact_dir}: shard {shard} out of range "
                             f"[0, {sb['n']})")
        slice_ = load_shard_slice(artifact_dir, int(shard), qmode)
        if flavor == "akx":
            head_model = model.precompute_split()[1]
    elif backend == "precomputed":
        cache = PropagationCache.load(
            os.path.join(artifact_dir, "propagation.npz"))
        if flavor == "akx":
            head_model = model.precompute_split()[1]
    else:
        if dataset is None:
            raise ValueError("full-graph serving needs the dataset (the "
                             "graph is not part of the artifact); pass "
                             "dataset=")
        want_v = int(manifest["num_nodes"])
        want_e = (manifest.get("dataset") or {}).get("E")
        if int(dataset.graph.num_nodes) != want_v or (
                want_e is not None
                and int(dataset.graph.num_edges) != int(want_e)):
            raise ValueError(
                f"dataset V={dataset.graph.num_nodes}/"
                f"E={dataset.graph.num_edges} != artifact "
                f"V={want_v}/E={want_e} — full-graph serving on another "
                f"graph than the export's would be silently wrong")
        gctx = _graph_context(model, dataset, config, device)
    return Predictor(model, config, params, backend, manifest["buckets"],
                     cache=cache, head_model=head_model, flavor=flavor,
                     dataset=dataset if backend == "full" else None,
                     gctx=gctx, num_classes=manifest.get("num_classes"),
                     quant=qmode, device=device, shard=slice_)


# ----------------------------------------------------------------- CLI

def parse_args(argv: Optional[List[str]] = None):
    import argparse
    from ..models import model_builders
    from ..train.cli import IMPLS
    from ..train.trainer import DTYPE_MODES
    ap = argparse.ArgumentParser(
        prog="python -m roc_tpu_torch.export", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", required=True,
                    help="artifact directory (created)")
    ap.add_argument("--checkpoint", default=None,
                    help="training checkpoint (v3 directory or legacy "
                         ".npz) to export; omitted = fresh Glorot "
                         "weights (a latency rehearsal, and the export "
                         "says so)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "precomputed", "full"],
                    help="'auto' = the precomputed table for the "
                         "fixed-propagation family (SGC shape), the "
                         "full-graph forward otherwise")
    ap.add_argument("--buckets", default=None,
                    help="comma list of microbatch buckets (default "
                         f"{','.join(str(b) for b in SERVE_BUCKETS)})")
    ap.add_argument("--model", default="gcn",
                    choices=sorted(model_builders()))
    ap.add_argument("-layers", default="16-16-4",
                    help="dash-separated dims (train/cli.py convention)")
    ap.add_argument("--hops", type=int, default=None)
    ap.add_argument("--alpha", type=float, default=None)
    ap.add_argument("--lam", type=float, default=None)
    ap.add_argument("--heads", type=int, default=None)
    ap.add_argument("--learn-eps", action="store_true", default=None)
    ap.add_argument("-dropout", type=float, default=0.5)
    ap.add_argument("-seed", type=int, default=1)
    ap.add_argument("-file", default=None, dest="file",
                    help="dataset prefix (default: the synthetic smoke "
                         "dataset, as the training CLI)")
    ap.add_argument("--dtype", default="float32", choices=DTYPE_MODES)
    ap.add_argument("--impl", default="cuda", choices=IMPLS)
    ap.add_argument("--fuse", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--quantize", default="off",
                    choices=["off", "int8", "fp8"],
                    help="serving-table and params quantization "
                         "(symmetric per-row, scales alongside); the "
                         "export runs the drift gate and refuses past "
                         "its thresholds")
    ap.add_argument("--drift-argmax-min", type=float, default=None,
                    help="drift gate: least argmax agreement with the "
                         "fp32 reference (default in serve/quant.py)")
    ap.add_argument("--drift-dlogit-max", type=float, default=None,
                    help="drift gate: largest relative |Δlogit| against "
                         "the fp32 reference (default in serve/quant.py)")
    ap.add_argument("--shards", type=int, default=0,
                    help="also write N per-shard propagation slices and a "
                         "shard manifest block (edge-balanced [lo,hi) "
                         "plan, fleet-uniform padded shape); a replica "
                         "then loads ONE slice (load_predictor(shard=k)) "
                         "at O(V/N)+halo table bytes")
    ap.add_argument("--cache-dir", default=None,
                    help="the JAX package's compile-cache directory; "
                         "accepted and ignored")
    ap.add_argument("--no-verify-warm", action="store_true",
                    help="the JAX package's warm-hit check; accepted and "
                         "ignored")
    ap.add_argument("--cpu", action="store_true",
                    help="export on the CPU (default: the card)")
    ap.add_argument("--events", default=None)
    ap.add_argument("-v", "--verbose", action="store_true")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    from ..train.cli import _build_model
    from ..train.trainer import TrainConfig, resolve_dtypes
    args = parse_args(argv)
    if args.events:
        from ..obs.events import configure
        configure(jsonl_path=args.events)
    if args.shards < 0:
        print("error: --shards must be >= 0", file=sys.stderr)
        return 2
    if args.cache_dir is not None or args.no_verify_warm:
        print("note: --cache-dir and --no-verify-warm drive the JAX "
              "package's compile cache, which eager PyTorch has no use "
              "for; ignored", file=sys.stderr)
    layers = [int(x) for x in args.layers.split("-")]
    if len(layers) < 2:
        print("error: -layers needs at least in-dim and classes",
              file=sys.stderr)
        return 2
    try:
        model = _build_model(args, layers)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"error: {e} (or --cpu)", file=sys.stderr)
        return 2
    from ..core.graph import load_dataset, synthetic_dataset
    if args.file:
        ds = load_dataset(args.file, in_dim=layers[0],
                          num_classes=layers[-1])
    else:
        ds = synthetic_dataset(512, 8, in_dim=layers[0],
                               num_classes=layers[-1], seed=args.seed)
    dt, cdt = resolve_dtypes(args.dtype)
    config = TrainConfig(verbose=args.verbose, seed=args.seed,
                         aggr_impl=args.impl, aggr_fuse=args.fuse,
                         dtype=dt, compute_dtype=cdt)
    params = None
    if args.checkpoint:
        from ..utils.checkpoint import dtype_name, restore_params_only
        params, fp, epoch = restore_params_only(args.checkpoint)
        strict = (fp or {}).get("strict") or {}
        if strict.get("dtype") and strict["dtype"] != dtype_name(dt):
            print(f"error: checkpoint dtype {strict['dtype']} != --dtype "
                  f"{dtype_name(dt)}; export with the training dtype",
                  file=sys.stderr)
            return 2
        emit("serve", f"weights from {args.checkpoint} (epoch {epoch})",
             kind="restore", epoch=epoch)
        params = {k: v.to(device, dt) for k, v in params.items()}
    else:
        emit("serve", "no --checkpoint: exporting FRESH Glorot weights "
             "(latency rehearsal, not a trained model)",
             kind="fresh_params")
    buckets = (SERVE_BUCKETS if not args.buckets
               else tuple(int(b) for b in args.buckets.split(",")))
    pred = build_predictor(model, ds, config, params=params,
                           backend=args.backend, buckets=buckets,
                           quant=args.quantize, device=device,
                           verbose=args.verbose)
    meta = {"V": int(ds.graph.num_nodes), "E": int(ds.graph.num_edges),
            "name": getattr(ds, "name", None), "prefix": args.file}
    if args.shards and pred.backend != "precomputed":
        print("error: sharded export applies to the precomputed table "
              "backend (--backend auto or precomputed)", file=sys.stderr)
        return 2
    manifest = export_predictor(pred, args.out, dataset_meta=meta,
                                drift_argmax_min=args.drift_argmax_min,
                                drift_dlogit_max=args.drift_dlogit_max,
                                shards=args.shards)
    sb = manifest["shards"]
    print(json.dumps({"artifact": args.out, "backend": manifest["backend"],
                      "flavor": manifest["flavor"],
                      "buckets": manifest["buckets"],
                      "quant": manifest["quant"],
                      "shards": None if not sb else {
                          k: sb[k] for k in ("n", "plan",
                                             "bytes_per_replica",
                                             "bytes_full")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
