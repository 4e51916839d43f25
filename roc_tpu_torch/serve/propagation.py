"""Precomputed propagation tables (``roc_tpu/serve/propagation.py``):
``S^k X`` evaluated once and served until an edge changes.

The SGC family's propagation has no parameters (models/sgc.py: ``logits
= S^k X W``), so at serving time the graph part of the model becomes a
lookup table: the prefix runs once (core/streaming.py
``stream_prefix_to_host``, the streamed tier's own walk: every stage on
the host, each tile's neighbour sum on the card through K3), its per-op
stages stay on the host, and a query is a row gather plus the dense
head.

:class:`PropagationCache` owns the stages and the invalidation: when a
vertex's edges change, only rows inside the changed vertices' k-hop
neighbourhood can change, so :meth:`PropagationCache.add_edges` walks
the op chain once on the host, growing the affected set at each
aggregation and recomputing exactly those rows from the stored previous
stage (norms are row-local; an aggregation spreads one hop).

Symmetric graphs only (out-neighbours == in-neighbours, so the CSR
serves both directions), as the training backward requires.  The npz
member names are the JAX package's, so a file written by either package
loads in the other.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..obs.events import emit
from ..ops.norm import inv_sqrt_degree_np

# the op-descriptor vocabulary the prefix walk accepts, persisted in the
# serving manifest
PREFIX_KINDS = ("indegree_norm", "scatter_gather", "fused_aggregate")


def prefix_descriptors(prefix_ops) -> List[Dict[str, Any]]:
    """Builder ``_Op`` list → JSON-serialisable descriptors."""
    out = []
    for op in prefix_ops:
        if op.kind not in PREFIX_KINDS:
            raise NotImplementedError(
                f"non-propagation op {op.kind!r} in a precompute prefix")
        d: Dict[str, Any] = {"kind": op.kind}
        if op.kind == "scatter_gather":
            d["aggr"] = op.attrs.get("aggr", "sum")
        if op.kind == "fused_aggregate":
            d["activation"] = op.attrs.get("activation", "none")
        out.append(d)
    return out


def _blob(obj) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8).copy()


def _unblob(arr) -> Any:
    return json.loads(bytes(np.asarray(arr)).decode())


class PropagationCache:
    """Host-resident propagation tables with incremental recompute.

    ``stages[i]`` is the fp32 ``[V, F]`` value after prefix op ``i``
    (``stages[-1]`` is the serving table); ``x0`` the feature matrix the
    chain starts from.  ``loaded_quant`` is the mode of the artifact the
    cache was loaded from (None for a built or fp32 cache)."""

    def __init__(self, row_ptr: np.ndarray, col_idx: np.ndarray,
                 ops: Sequence[Dict[str, Any]], x0: np.ndarray,
                 stages: List[np.ndarray]):
        self.row_ptr = np.asarray(row_ptr, dtype=np.int64)
        self.col_idx = np.asarray(col_idx, dtype=np.int32)
        self.ops = [dict(op) for op in ops]
        self.x0 = x0
        self.stages = stages
        self.inv_sqrt = inv_sqrt_degree_np(np.diff(self.row_ptr))
        # host-table mutation generation: one per add_edges batch (the
        # device-side version is Predictor's publish counter)
        self.version = 0
        self.loaded_quant: Optional[str] = None

    # ------------------------------------------------------------ build

    @classmethod
    def build(cls, graph, ops: Sequence[Dict[str, Any]],
              feats: np.ndarray, block_rows: int = 65536,
              prefetch: int = 1, table_only: bool = False,
              device=None) -> "PropagationCache":
        """Evaluate the prefix over the whole graph through the trainer's
        own precompute walk (core/streaming.py ``stream_prefix_to_host``:
        ``block_rows``-row blocks staged through a pool of depth
        ``prefetch`` to ``device``, the card unless the caller passes
        another), keeping every stage for invalidation.  ``table_only``
        keeps the last stage alone (a cache that cannot invalidate, as a
        logits table cannot)."""
        from ..core.streaming import stream_prefix_to_host
        x0 = np.asarray(feats, dtype=np.float32).copy()
        stages: List[np.ndarray] = []
        stream_prefix_to_host(graph, list(ops), x0, block_rows=block_rows,
                              prefetch=prefetch, capture=stages,
                              device=device)
        if not stages:
            raise ValueError("empty propagation prefix")
        if table_only:
            stages = [stages[-1]]
            x0 = np.zeros((0, 0), dtype=np.float32)
            ops = [{"kind": "opaque"}]
        return cls(graph.row_ptr, graph.col_idx, ops, x0, stages)

    @property
    def table(self) -> np.ndarray:
        """The serving table: the last prefix stage, fp32 ``[V, F]``."""
        return self.stages[-1]

    @property
    def num_nodes(self) -> int:
        return int(self.row_ptr.shape[0] - 1)

    # ----------------------------------------------------- invalidation

    def _in_rows(self, r: int) -> np.ndarray:
        return self.col_idx[self.row_ptr[r]:self.row_ptr[r + 1]]

    def _neighbors_of(self, rows: np.ndarray) -> np.ndarray:
        """Union of the rows' neighbourhoods (symmetric CSR)."""
        if rows.size == 0:
            return rows
        chunks = [self.col_idx[self.row_ptr[r]:self.row_ptr[r + 1]]
                  for r in rows]
        return np.unique(np.concatenate(chunks)) if chunks else rows

    def add_edges(self, src, dst) -> np.ndarray:
        """Append edges and recompute, on the host, every stage row the
        change can reach; returns the last-stage rows that changed (the
        caller publishes exactly those, ``Predictor.refresh_rows``).
        ``src``/``dst`` are parallel id arrays; a symmetric graph needs
        both directions listed.  The recomputed rows equal a rebuild on
        the mutated graph to fp32 roundoff."""
        if len(self.ops) == 1 and self.ops[0].get("kind") == "opaque":
            raise NotImplementedError(
                "this cache was built table_only=True (or holds a "
                "full-logits table) — incremental invalidation needs "
                "the per-op stages; re-export the artifact instead")
        src = np.asarray(src, dtype=np.int32).ravel()
        dst = np.asarray(dst, dtype=np.int32).ravel()
        if src.shape != dst.shape:
            raise ValueError("src/dst length mismatch")
        V = self.num_nodes
        if src.size and (src.min() < 0 or src.max() >= V
                         or dst.min() < 0 or dst.max() >= V):
            raise ValueError(f"edge ids out of range [0, {V})")
        # CSR insert: edge (s, d) lands at the end of row d's slice
        order = np.argsort(dst, kind="stable")
        s_sorted, d_sorted = src[order], dst[order]
        insert_at = self.row_ptr[d_sorted + 1]
        new_col = np.insert(self.col_idx, insert_at, s_sorted)
        counts = np.bincount(d_sorted, minlength=V).astype(np.int64)
        new_ptr = self.row_ptr + np.concatenate(([0], np.cumsum(counts)))
        self.row_ptr, self.col_idx = new_ptr, new_col
        # the destinations' degrees changed, so their rows change at
        # every norm stage: they seed the affected set
        changed = np.unique(d_sorted)
        self.inv_sqrt = inv_sqrt_degree_np(np.diff(self.row_ptr))
        deg = np.maximum(np.diff(self.row_ptr).astype(np.float32), 1.0)
        affected = changed
        prev_of = [self.x0] + self.stages[:-1]
        for i, op in enumerate(self.ops):
            prev, cur = prev_of[i], self.stages[i]
            kind = op["kind"]
            if kind == "indegree_norm":
                cur[affected] = (prev[affected]
                                 * self.inv_sqrt[affected, None])
            elif kind in ("scatter_gather", "fused_aggregate"):
                # one hop of spread: rows whose neighbourhood holds an
                # affected row, plus the rows whose edges changed
                affected = np.union1d(affected,
                                      self._neighbors_of(affected))
                if kind == "fused_aggregate":
                    for r in affected:
                        nbr = self._in_rows(r)
                        cur[r] = (prev[nbr]
                                  * self.inv_sqrt[nbr, None]).sum(axis=0)
                    cur[affected] *= self.inv_sqrt[affected, None]
                    if op.get("activation", "none") != "none":
                        # an assignment: np.maximum(..., out=) on a fancy
                        # index would write a temporary copy
                        cur[affected] = np.maximum(cur[affected], 0.0)
                else:
                    for r in affected:
                        cur[r] = prev[self._in_rows(r)].sum(axis=0)
                    if op.get("aggr", "sum") == "avg":
                        cur[affected] /= deg[affected, None]
            else:
                raise NotImplementedError(kind)
        self.version += 1
        emit("serve", f"invalidate: {src.size} edge(s) appended, "
             f"{affected.size} table row(s) recomputed "
             f"({affected.size / max(V, 1):.2%} of V, host table "
             f"generation {self.version})", console=False,
             kind="invalidate", edges=int(src.size),
             rows=int(affected.size), version=self.version)
        return affected

    # ------------------------------------------------------ persistence

    def save(self, path: str, quant: str = "off") -> None:
        """Persist the cache (atomic rename).  ``quant`` 'int8'/'fp8'
        stores each stage as ``stage_{i}_q`` (its code bytes) and
        ``stage_{i}_scale``, with the spec in the ``quant`` blob; ``x0``
        stays fp32 either way (the chain's seed)."""
        data: Dict[str, np.ndarray] = {
            "row_ptr": self.row_ptr, "col_idx": self.col_idx,
            "x0": self.x0, "ops": _blob(self.ops)}
        if quant != "off":
            from .quant import (QuantSpec, check_mode, quantize_rows,
                                to_storage_bytes)
            check_mode(quant)
            for i, s in enumerate(self.stages):
                q, sc = quantize_rows(s, quant)
                data[f"stage_{i}_q"] = to_storage_bytes(q)
                data[f"stage_{i}_scale"] = sc
            data["quant"] = _blob(QuantSpec(quant).to_json())
        else:
            for i, s in enumerate(self.stages):
                data[f"stage_{i}"] = s
        d = os.path.dirname(os.path.abspath(path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **data)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def load(cls, path: str) -> "PropagationCache":
        """Rebuild from disk.  A quantized file dequantizes into fp32
        host stages (the invalidation math is mode-blind); the serving
        manifest names the mode, and the predictor re-quantizes the
        device table under it, which reproduces the stored codes bit for
        bit."""
        with np.load(path) as z:
            ops = _unblob(z["ops"])
            if "quant" in z.files:
                from .quant import (QuantSpec, dequantize_rows,
                                    from_storage_bytes)
                spec = QuantSpec.from_json(_unblob(z["quant"]))
                n = sum(1 for k in z.files
                        if k.startswith("stage_") and k.endswith("_q"))
                stages = [dequantize_rows(
                    from_storage_bytes(z[f"stage_{i}_q"], spec.mode),
                    z[f"stage_{i}_scale"]) for i in range(n)]
                out = cls(z["row_ptr"], z["col_idx"], ops, z["x0"], stages)
                out.loaded_quant = spec.mode
                return out
            n = sum(1 for k in z.files if k.startswith("stage_"))
            stages = [z[f"stage_{i}"] for i in range(n)]
            return cls(z["row_ptr"], z["col_idx"], ops, z["x0"], stages)


def logits_table_cache(table: np.ndarray) -> PropagationCache:
    """Wrap a precomputed full-logits table (the 'table' flavor: the
    frozen forward is the cached object, as for APPNP, where propagation
    runs after the MLP) in the same container; :meth:`add_edges`
    refuses with the re-export message."""
    t = np.asarray(table, dtype=np.float32)
    V = t.shape[0]
    return PropagationCache(
        np.zeros(V + 1, dtype=np.int64), np.zeros(0, dtype=np.int32),
        [{"kind": "opaque"}], np.zeros((0, 0), dtype=np.float32), [t])
