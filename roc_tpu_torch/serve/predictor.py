"""The serving runtime (``roc_tpu/serve/predictor.py``): a frozen-params
query engine with two backends.

- ``backend='precomputed'`` (the fixed-propagation family): a
  device-resident table (serve/propagation.py) and a ``gather rows ->
  dense head`` step, with no graph op on the request path.  Flavor
  ``akx`` holds ``S^k X`` and runs the model's dense head on the
  gathered rows; flavor ``table`` holds the frozen full-forward logits
  and the step is the gather itself.  A quantized table (int8 or fp8
  codes and fp32 per-row scales, serve/quant.py) is dequantized on the
  gathered ``[bucket, F]`` rows only.
- ``backend='full'``: every dispatch runs the whole-graph forward on the
  model's device (the route and graph context serving was built with)
  and gathers the queried rows there.

Request batch sizes pad to :data:`SERVE_BUCKETS`, so a dispatch always
has one of a few shapes; padded slots query the zero pad row (index V,
precomputed) or row 0 (full) and their logits are dropped.  Dispatches
run under ``torch.inference_mode`` in the config's compute dtype (bf16
in the 'mixed' and 'bfloat16' modes); :meth:`Predictor.query` returns
fp32 numpy logits in every mode.  Every step is deterministic, so a row
served in a coalesced dispatch has the bits it has served alone.

Tables are versioned: :meth:`Predictor.published` is one attribute read
of a :class:`TableVersion`, and a publish (an invalidation, a refresh, a
quant swap) builds a NEW tensor under the publish lock, so a microbatch
pinned to version k finishes on k's values.

A sharded predictor (``shard=`` a :class:`ShardSlice` of an artifact
exported with ``--shards``) holds the rows ``[lo, hi)`` of the table in
the fleet-uniform device layout ``[rows_padded + halo + 1, F]`` and a host
mirror of them, and answers the same global ids: owned ids remap to
their local rows; the foreign ids of a microbatch are fetched once
through ``gather_fn`` at the microbatch's pinned version and staged in a
``[n, F]`` tensor of that microbatch alone, copied over the gathered
rows.  The owner side is :meth:`Predictor.read_rows`, the sharded
refresh :meth:`Predictor.apply_refresh`.
"""

from __future__ import annotations

import threading
import time
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.events import emit
from ..train.trainer import cast_floats, compute_dtype_of
from .errors import GatherError
from .propagation import PropagationCache

# The padded microbatch sizes a server dispatches.
SERVE_BUCKETS: Tuple[int, ...] = (1, 8, 64, 512)


class TableVersion(NamedTuple):
    """One published serving table.  ``table`` is the device tensor
    every dispatch under ``version`` gathers from: the propagation table
    (precomputed backend; int8 codes, or fp8 codes as uint8 bytes, when
    ``qmode`` is not 'off', with ``scale`` the fp32 per-row scales) or
    the feature matrix (full backend).  A publish never mutates the
    previous version's tensors."""
    version: int
    table: Any
    scale: Any = None
    qmode: str = "off"


class ShardSlice(NamedTuple):
    """One exported slice of a propagation table: the rows ``[lo, hi)`` a
    shard owns, and the layout every shard of the fleet shares.
    ``rows_padded`` is the largest shard's row count rounded up to the
    partition ``NODE_MULTIPLE``, ``halo`` the staging room for gathered
    foreign rows (the largest serve bucket), so every shard's device
    table is ``[rows_padded + halo + 1, F]``.  An fp32 slice carries
    ``rows``; a quantized one ``codes`` and per-row ``scales`` cut from
    the full table's (per-row quantization is row-local), and
    ``scale_guard``, the full table's largest scale, which refreshed rows
    are held to."""
    lo: int
    hi: int
    num_nodes: int
    rows_padded: int
    halo: int
    rows: Optional[np.ndarray] = None
    codes: Optional[np.ndarray] = None
    scales: Optional[np.ndarray] = None
    scale_guard: Optional[float] = None


class _Staged(NamedTuple):
    """A microbatch's gathered foreign rows: the bucket positions they
    answer, their values (codes when quantized) and scales, on the
    device."""
    pos: Any
    vals: Any
    scales: Any = None


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; requests past the largest bucket are split
    into largest-bucket chunks by the caller."""
    for b in buckets:
        if n <= b:
            return b
    return max(buckets)


class Predictor:
    """Frozen-params query engine.  Build it with
    :func:`roc_tpu_torch.serve.export.build_predictor` (live objects) or
    :func:`roc_tpu_torch.serve.export.load_predictor` (an artifact)."""

    def __init__(self, model, config, params, backend: str,
                 buckets: Sequence[int],
                 cache: Optional[PropagationCache] = None,
                 head_model=None, flavor: Optional[str] = None,
                 dataset=None, gctx=None,
                 num_classes: Optional[int] = None, quant: str = "off",
                 device=None, shard: Optional[ShardSlice] = None):
        from .quant import check_mode
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or any(b < 1 for b in self.buckets):
            raise ValueError(f"bad serve buckets {buckets!r}")
        self.model = model
        self.config = config
        self.backend = backend
        self.flavor = flavor
        self.device = torch.device(device)
        self.compute = compute_dtype_of(config)
        self.set_params(params)
        self.num_classes = num_classes
        self.cache = cache
        self.head_model = head_model
        self.quant = check_mode(quant)
        if self.quant != "off" and backend != "precomputed":
            raise ValueError("quantized serving applies to the "
                             "precomputed table backend only (the "
                             "full-graph path has no table to shrink)")
        self.gctx = gctx
        self._scale_guard: Optional[float] = None
        self._pub_lock = threading.Lock()
        # the sharded surface: the owned (lo, hi), the gather leg
        # (``gather_fn(ids, version) -> (values, scales, version,
        # qmode)``) and the last query's gather wall; None unsharded
        self.shard: Optional[Tuple[int, int]] = None
        self.gather_fn = None
        self.last_gather_ms: Optional[float] = None
        if backend == "precomputed":
            if flavor == "akx" and head_model is None:
                raise ValueError("the 'akx' flavor needs the head model")
            if shard is not None:
                self.shard = (int(shard.lo), int(shard.hi))
                self.num_nodes = int(shard.num_nodes)
                self._rows_padded = int(shard.rows_padded)
                self.halo = int(shard.halo)
                # the last row, zero, absorbs padded slots
                self.pad_id = self._rows_padded + self.halo
                table, scale = self._device_table_shard(shard)
            elif cache is None:
                raise ValueError("precomputed backend needs a "
                                 "PropagationCache (or a ShardSlice)")
            else:
                self.num_nodes = cache.num_nodes
                # the zero row at index V absorbs padded slots
                self.pad_id = self.num_nodes
                table, scale = self._device_table(self.quant)
            self._published = TableVersion(0, table, scale, self.quant)
        elif backend == "full":
            if dataset is None or gctx is None:
                raise ValueError("full backend needs dataset + gctx")
            self.num_nodes = dataset.graph.num_nodes
            self.pad_id = 0   # any valid row; padded outputs are discarded
            feats = torch.as_tensor(np.asarray(dataset.features),
                                    dtype=self.compute).to(self.device)
            self._published = TableVersion(0, feats)
        else:
            raise ValueError(f"unknown serve backend {backend!r}; "
                             "expected 'precomputed' or 'full'")

    def set_params(self, params) -> None:
        """Take ``params``: ``master_params`` in the config's dtype (what
        an export stores) and ``params``, their compute-dtype cast, which
        every dispatch reads."""
        self.master_params = {
            k: (v.detach().to(self.device, self.config.dtype)
                if v.is_floating_point() else v.detach().to(self.device))
            for k, v in params.items()}
        self.params = cast_floats(self.master_params, self.compute)

    # ---------------------------------------------------------- tables

    def _codes(self, q: np.ndarray) -> torch.Tensor:
        """Host codes (int8, or fp8 bytes as uint8) → a device tensor of
        the same bytes."""
        return torch.from_numpy(np.ascontiguousarray(q)).to(self.device)

    def _device_table(self, mode: str):
        """Upload the host table under ``mode``: fp32 → the compute
        dtype; quantized → ``(codes, scales)``.  The pad row at index V is
        zero, its scale 1.0.  A quantized upload also pins the scale
        envelope refreshed rows are held to."""
        host = self.cache.table
        V, F = host.shape
        if mode == "off":
            t = torch.zeros((V + 1, F), dtype=self.compute,
                            device=self.device)
            t[:V] = torch.from_numpy(np.ascontiguousarray(
                host, dtype=np.float32)).to(self.device)
            return t, None
        from .quant import SCALE_GUARD_SLACK, quantize_rows
        q, sc = quantize_rows(host, mode)
        self._scale_guard = float(sc.max()) * SCALE_GUARD_SLACK
        codes = torch.zeros((V + 1, F), dtype=torch.int8 if mode == "int8"
                            else torch.uint8, device=self.device)
        codes[:V] = self._codes(q)
        scale = torch.ones(V + 1, dtype=torch.float32, device=self.device)
        scale[:V] = torch.from_numpy(sc).to(self.device)
        return codes, scale

    def _device_table_shard(self, sl: ShardSlice):
        """Upload a slice in the fleet-uniform layout: owned rows at ``[0,
        hi - lo)``, zeros through ``rows_padded``, ``halo`` zero rows and
        the zero pad row; quantized scales 1.0 outside the owned rows.
        Keeps the slice on the host too: :meth:`read_rows` answers from
        it."""
        own = sl.hi - sl.lo
        n = self._rows_padded + self.halo + 1
        if self.quant == "off":
            if sl.rows is None:
                raise ValueError("fp32 shard slice carries no rows")
            self._host_rows = np.array(sl.rows, dtype=np.float32)
            t = torch.zeros((n, self._host_rows.shape[1]),
                            dtype=self.compute, device=self.device)
            t[:own] = torch.from_numpy(self._host_rows).to(self.device)
            return t, None
        from .quant import SCALE_GUARD_SLACK, storage_dtype
        if sl.codes is None or sl.scales is None:
            raise ValueError("quantized shard slice needs codes + scales")
        self._host_codes = np.array(sl.codes,
                                    dtype=storage_dtype(self.quant))
        self._host_scales = np.array(sl.scales, dtype=np.float32)
        guard = sl.scale_guard
        if guard is None and own:
            # the slice's own envelope (an export always stores the
            # full table's)
            guard = float(self._host_scales.max())
        self._scale_guard = float(guard or 1.0) * SCALE_GUARD_SLACK
        codes = torch.zeros((n, self._host_codes.shape[1]),
                            dtype=torch.int8 if self.quant == "int8"
                            else torch.uint8, device=self.device)
        codes[:own] = self._codes(self._host_codes)
        scale = torch.ones(n, dtype=torch.float32, device=self.device)
        scale[:own] = torch.from_numpy(self._host_scales).to(self.device)
        return codes, scale

    def table_bytes(self) -> int:
        """Device bytes of the current published table (codes and
        per-row scales when quantized; the feature matrix on the full
        backend)."""
        from .quant import table_bytes as _tb
        pub = self._published
        if pub.qmode == "off":
            return int(pub.table.numel() * pub.table.element_size())
        return int(_tb(tuple(int(d) for d in pub.table.shape), pub.qmode))

    # --------------------------------------------------------- queries

    def published(self) -> TableVersion:
        """A consistent snapshot of the current table version; a
        microbatch captures it once and is served from it."""
        return self._published

    def _gather(self, pub: TableVersion, ids_padded: torch.Tensor,
                staged: Optional[_Staged] = None) -> torch.Tensor:
        """The bucket's table rows in the compute dtype, with a shard's
        staged foreign rows copied over their positions; quantized rows
        widen after the gather, never the ``[V, F]`` table."""
        rows = pub.table.index_select(0, ids_padded)
        if staged is not None:
            rows.index_copy_(0, staged.pos, staged.vals)
        if pub.qmode == "off":
            return rows
        if pub.qmode == "fp8":
            rows = rows.view(torch.float8_e4m3fn)
        s = pub.scale.index_select(0, ids_padded)
        if staged is not None:
            s.index_copy_(0, staged.pos, staged.scales)
        return rows.to(self.compute) * s[:, None].to(self.compute)

    def query_device(self, ids_padded: torch.Tensor,
                     pub: Optional[TableVersion] = None,
                     staged: Optional[_Staged] = None) -> torch.Tensor:
        """One padded-bucket dispatch: the device logits ``[bucket, C]``
        of rows ``ids_padded`` (an int tensor on the model's device whose
        length is a bucket), under version ``pub`` (the current one when
        None); ``staged`` carries a shard's gathered foreign rows."""
        b = int(ids_padded.shape[0])
        if b not in self.buckets:
            raise ValueError(f"ids length {b} is not a bucket "
                             f"{self.buckets}")
        if pub is None:
            pub = self._published
        with torch.inference_mode():
            if self.backend == "precomputed":
                x = self._gather(pub, ids_padded, staged)
                if self.flavor == "table":
                    return x
                return self.head_model.apply(self.params, x, None,
                                             train=False)
            logits = self.model.apply(self.params, pub.table, self.gctx,
                                      train=False)
            return logits.index_select(0, ids_padded)

    def query(self, node_ids,
              pub: Optional[TableVersion] = None) -> np.ndarray:
        """Pad to the smallest fitting bucket, dispatch, fetch, slice;
        ids past the largest bucket go in largest-bucket chunks, all
        under one version.  The microbatch server (serve/server.py)
        coalesces concurrent requests into one such call.  A shard takes
        global ids and gathers its foreign ones once per chunk;
        ``last_gather_ms`` is the query's summed gather wall (None when
        every id was owned)."""
        ids = np.asarray(node_ids, dtype=np.int64).ravel()
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_nodes):
            raise ValueError(f"node ids out of range [0, {self.num_nodes})")
        if pub is None:
            pub = self.published()
        self.last_gather_ms = None
        out = []
        cap = max(self.buckets)
        for lo in range(0, ids.size, cap):
            chunk = ids[lo:lo + cap]
            staged = None
            if self.shard is not None:
                chunk, staged = self._remap_chunk(chunk, pub)
            padded = np.full(bucket_for(chunk.size, self.buckets),
                             self.pad_id, dtype=np.int64)
            padded[:chunk.size] = chunk
            logits = self.query_device(
                torch.from_numpy(padded).to(self.device), pub, staged)
            # the result itself, returned to the caller
            # roc-lint: ok=host-sync-hot-path
            out.append(logits[:chunk.size].to(torch.float32).cpu().numpy())
        return (np.concatenate(out) if out
                else np.zeros((0, self.num_classes or 0), np.float32))

    # --------------------------------------------------- sharded tables

    def _remap_chunk(self, chunk: np.ndarray, pub: TableVersion
                     ) -> Tuple[np.ndarray, Optional[_Staged]]:
        """Global chunk ids -> local table rows: owned ids offset into
        ``[0, hi - lo)``; foreign ids are gathered (each once) and point
        at their halo slots, their rows staged for the gather."""
        lo, hi = self.shard
        local = chunk - lo
        foreign = (chunk < lo) | (chunk >= hi)
        if not foreign.any():
            return local, None
        uniq = np.unique(chunk[foreign])
        vals, scales = self._stage_foreign(uniq, pub)
        slot = np.searchsorted(uniq, chunk[foreign])
        local[foreign] = self._rows_padded + slot
        sel = torch.from_numpy(slot).to(self.device)
        pos = torch.from_numpy(np.nonzero(foreign)[0]).to(self.device)
        return local, _Staged(pos, vals.index_select(0, sel),
                              None if scales is None
                              else scales.index_select(0, sel))

    def _stage_foreign(self, uniq: np.ndarray, pub: TableVersion):
        """Fetch the foreign rows ``uniq`` at exactly ``pub``'s version
        and qmode, as device tensors (codes and scales when quantized).
        The gather is pinned: an answer from another version or qmode is
        retried once (the owner may be mid-publish), then refused with
        :class:`GatherError`."""
        if self.gather_fn is None:
            raise GatherError(
                f"shard [{self.shard[0]}, {self.shard[1]}) was asked for "
                f"{uniq.size} foreign row(s) but has no gather_fn — "
                f"sharded serving needs the cross-shard gather leg")
        if uniq.size > self.halo:
            raise GatherError(
                f"{uniq.size} unique foreign rows exceed the halo staging "
                f"region ({self.halo}); chunking must cap a microbatch at "
                f"the largest bucket")
        t0 = time.perf_counter()
        vals, scales, ver, qmode = self.gather_fn(uniq, pub.version)
        if ver != pub.version or qmode != pub.qmode:
            vals, scales, ver, qmode = self.gather_fn(uniq, pub.version)
        if ver != pub.version or qmode != pub.qmode:
            raise GatherError(
                f"gather pinned to v{pub.version}:{pub.qmode} was answered "
                f"from v{ver}:{qmode} twice — refusing to mix table "
                f"versions in one microbatch")
        if pub.qmode == "off":
            v = torch.from_numpy(np.ascontiguousarray(
                vals, dtype=np.float32)).to(self.device, self.compute)
            s = None
        else:
            from .quant import storage_dtype
            v = self._codes(np.asarray(vals,
                                       dtype=storage_dtype(pub.qmode)))
            s = torch.from_numpy(np.ascontiguousarray(
                scales, dtype=np.float32)).to(self.device)
        self.last_gather_ms = ((self.last_gather_ms or 0.0)
                               + (time.perf_counter() - t0) * 1e3)
        return v, s

    def read_rows(self, ids, version: int):
        """The gather's owner side: the stored rows of ``ids`` (which
        this predictor must own) at exactly table ``version``, as host
        ``(values, scales, version, qmode)``: fp32 rows and None, or
        codes and per-row scales.  A shard answers from its host mirror,
        a full table re-encodes the rows of its host cache (per-row, so
        the same codes).  Another version than the published one, or an
        id outside the owned range, is refused with
        :class:`GatherError`: the requester's pin decides what follows."""
        if self.backend != "precomputed":
            raise GatherError("row fetches need the precomputed table "
                              "backend")
        ids = np.asarray(ids, dtype=np.int64).ravel()
        lo, hi = self.shard if self.shard is not None \
            else (0, self.num_nodes)
        if ids.size and (ids.min() < lo or ids.max() >= hi):
            raise GatherError(
                f"row fetch for ids outside owned range [{lo}, {hi})")
        local = ids - lo
        with self._pub_lock:
            pub = self._published
            if int(version) != pub.version:
                raise GatherError(
                    f"row fetch pinned to v{version} refused: this "
                    f"replica publishes v{pub.version}")
            if self.shard is not None:
                if pub.qmode != "off":
                    return (self._host_codes[local],
                            self._host_scales[local], pub.version,
                            pub.qmode)
                return self._host_rows[local], None, pub.version, "off"
            # the requested rows only (a row fetch)
            # roc-lint: ok=dequant-hot-path
            vals = np.asarray(self.cache.table[local], dtype=np.float32)
        if pub.qmode != "off":
            from .quant import quantize_rows
            q, sc = quantize_rows(vals, pub.qmode)
            return q, sc, pub.version, pub.qmode
        return vals, None, pub.version, "off"

    def apply_refresh(self, rows: np.ndarray, values: np.ndarray) -> int:
        """The sharded half of an edge-append refresh: the predictor that
        holds the full cache recomputes the rows and sends every shard
        the (global rows, fp32 values); a shard applies the rows it owns
        and publishes a new version either way (an epoch-only bump when
        it owns none), so the fleet's versions stay comparable and a
        gather stays pinnable.  Returns the rows applied."""
        if self.shard is None:
            raise NotImplementedError(
                "apply_refresh is the sharded refresh; a full-table "
                "predictor uses invalidate() or refresh_rows()")
        rows = np.asarray(rows, dtype=np.int64).ravel()
        values = np.asarray(values, dtype=np.float32)
        lo, hi = self.shard
        mask = (rows >= lo) & (rows < hi)
        own = rows[mask] - lo
        vals = values[mask]
        with self._pub_lock:
            old = self._published
            version = old.version + 1
            table, scale = old.table, old.scale
            if own.size:
                # copy-on-write publish: its uploads hold the writers' lock
                # only; readers never take it
                # roc-lint: ok=blocking-under-lock
                idx = torch.from_numpy(own).to(self.device)
                if old.qmode != "off":
                    from .quant import QuantDriftError, quantize_rows
                    q, sc = quantize_rows(vals, old.qmode)
                    smax = float(sc.max())
                    if (self._scale_guard is not None
                            and smax > self._scale_guard):
                        raise QuantDriftError(
                            f"sharded refresh refused: row scale "
                            f"{smax:.6g} exceeds the gated envelope "
                            f"{self._scale_guard:.6g}; serving stays on "
                            f"v{old.version}")
                    self._host_codes[own] = q
                    self._host_scales[own] = sc
                    # roc-lint: ok=blocking-under-lock
                    table = old.table.index_copy(0, idx, self._codes(q))
                    scale = old.scale.index_copy(
                        # roc-lint: ok=blocking-under-lock
                        0, idx, torch.from_numpy(sc).to(self.device))
                else:
                    self._host_rows[own] = vals
                    # roc-lint: ok=blocking-under-lock
                    table = old.table.index_copy(0, idx, torch.from_numpy(
                        np.ascontiguousarray(vals)).to(self.device,
                                                       self.compute))
            self._published = TableVersion(version, table, scale,
                                           old.qmode)
        self._emit_publish(version, own)
        return int(own.size)

    # ---------------------------------------------------- invalidation

    def _need_cache(self, what: str) -> None:
        if self.shard is not None:
            raise NotImplementedError(
                f"{what} needs the full host cache, which a shard does not "
                "hold: a shard takes (rows, values) through apply_refresh")
        if self.backend != "precomputed" or self.cache is None:
            raise NotImplementedError(
                f"{what} needs the precomputed backend (full-graph "
                "serving recomputes every dispatch anyway)")

    def invalidate(self, src, dst) -> int:
        """Edge-append invalidation: recompute the k-hop rows of the
        host table (``PropagationCache.add_edges``) and publish a new
        version carrying exactly those rows.  Returns the number of rows
        refreshed.  Writers serialise on the publish lock; readers never
        take it."""
        self._need_cache("invalidation")
        with self._pub_lock:
            rows = self.cache.add_edges(src, dst)
            # copy-on-write publish: writers only; readers never lock
            # roc-lint: ok=blocking-under-lock
            version = self._publish_rows_locked(rows)
        self._emit_publish(version, rows)
        return int(rows.size)

    def refresh_rows(self, rows: np.ndarray) -> None:
        """Publish a new version with ``rows`` re-uploaded from the host
        cache; the previous version's tensors stay as they were."""
        self._need_cache("a row refresh")
        rows = np.asarray(rows, dtype=np.int64).ravel()
        with self._pub_lock:
            # copy-on-write publish: writers only; readers never lock
            # roc-lint: ok=blocking-under-lock
            version = self._publish_rows_locked(rows)
        self._emit_publish(version, rows)

    def _publish_rows_locked(self, rows: np.ndarray) -> Optional[int]:
        """Copy-on-write publish (lock held): the new version's tensors
        are the old ones with ``rows`` rewritten (``index_copy`` returns
        a new tensor).  A quantized version re-encodes only those rows;
        per-row scales are row-local, so the codes equal a full
        re-quantization's.  A row whose scale leaves the envelope
        refuses, with the old version still published."""
        if rows.size == 0:
            return None
        old = self._published
        idx = torch.from_numpy(rows.astype(np.int64)).to(self.device)
        if old.qmode != "off":
            from .quant import QuantDriftError, quantize_rows
            q, sc = quantize_rows(self.cache.table[rows], old.qmode)
            smax = float(sc.max())
            if self._scale_guard is not None and smax > self._scale_guard:
                raise QuantDriftError(
                    f"invalidation refused: refreshed row scale "
                    f"{smax:.6g} exceeds the gated envelope "
                    f"{self._scale_guard:.6g} (build max × slack); "
                    f"serving stays on v{old.version} — re-export to "
                    f"re-run the drift gate on the mutated graph")
            table = old.table.index_copy(0, idx, self._codes(q))
            scale = old.scale.index_copy(
                0, idx, torch.from_numpy(sc).to(self.device))
        else:
            vals = torch.from_numpy(np.ascontiguousarray(
                self.cache.table[rows], dtype=np.float32)).to(
                    self.device, self.compute)
            table, scale = old.table.index_copy(0, idx, vals), None
        self._published = TableVersion(old.version + 1, table, scale,
                                       old.qmode)
        return old.version + 1

    def publish_quant(self, mode: str) -> int:
        """Re-publish the current host table under another quant mode
        (the mid-rollout fp32 -> int8 swap, or back) as one new version;
        batches pinned to the previous version finish on its tensors and
        its mode.  Returns the published version."""
        from .quant import check_mode
        self._need_cache("a quant swap")
        mode = check_mode(mode)
        with self._pub_lock:
            old = self._published
            # copy-on-write publish: writers only; readers never lock
            # roc-lint: ok=blocking-under-lock
            table, scale = self._device_table(mode)
            self.quant = mode
            version = old.version + 1
            self._published = TableVersion(version, table, scale, mode)
        emit("serve", f"table version {version} published "
             f"(quant swap {old.qmode}->{mode}; in-flight queries "
             f"finish on v{old.version}:{old.qmode})", console=False,
             kind="table_publish", version=version, rows=0, qmode=mode)
        return version

    def _emit_publish(self, version: Optional[int],
                      rows: np.ndarray) -> None:
        # after the lock is released: no event I/O inside the publish
        if version is None:
            return
        emit("serve", f"table version {version} published "
             f"({rows.size} row(s) rewritten; in-flight queries "
             f"finish on v{version - 1})", console=False,
             kind="table_publish", version=version, rows=int(rows.size))
