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
"""

from __future__ import annotations

import threading
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obs.events import emit
from ..train.trainer import cast_floats, compute_dtype_of
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
                 device=None):
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
        if backend == "precomputed":
            if cache is None:
                raise ValueError("precomputed backend needs a "
                                 "PropagationCache")
            if flavor == "akx" and head_model is None:
                raise ValueError("the 'akx' flavor needs the head model")
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

    def _gather(self, pub: TableVersion,
                ids_padded: torch.Tensor) -> torch.Tensor:
        """The bucket's table rows in the compute dtype; quantized rows
        widen after the gather, never the ``[V, F]`` table."""
        rows = pub.table.index_select(0, ids_padded)
        if pub.qmode == "off":
            return rows
        if pub.qmode == "fp8":
            rows = rows.view(torch.float8_e4m3fn)
        s = pub.scale.index_select(0, ids_padded)
        return rows.to(self.compute) * s[:, None].to(self.compute)

    def query_device(self, ids_padded: torch.Tensor,
                     pub: Optional[TableVersion] = None) -> torch.Tensor:
        """One padded-bucket dispatch: the device logits ``[bucket, C]``
        of rows ``ids_padded`` (an int tensor on the model's device whose
        length is a bucket), under version ``pub`` (the current one when
        None)."""
        b = int(ids_padded.shape[0])
        if b not in self.buckets:
            raise ValueError(f"ids length {b} is not a bucket "
                             f"{self.buckets}")
        if pub is None:
            pub = self._published
        with torch.inference_mode():
            if self.backend == "precomputed":
                x = self._gather(pub, ids_padded)
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
        coalesces concurrent requests into one such call."""
        ids = np.asarray(node_ids, dtype=np.int64).ravel()
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_nodes):
            raise ValueError(f"node ids out of range [0, {self.num_nodes})")
        if pub is None:
            pub = self.published()
        out = []
        cap = max(self.buckets)
        for lo in range(0, ids.size, cap):
            chunk = ids[lo:lo + cap]
            padded = np.full(bucket_for(chunk.size, self.buckets),
                             self.pad_id, dtype=np.int64)
            padded[:chunk.size] = chunk
            logits = self.query_device(
                torch.from_numpy(padded).to(self.device), pub)
            out.append(logits[:chunk.size].to(torch.float32).cpu().numpy())
        return (np.concatenate(out) if out
                else np.zeros((0, self.num_classes or 0), np.float32))

    # ---------------------------------------------------- invalidation

    def _need_cache(self, what: str) -> None:
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
            version = self._publish_rows_locked(rows)
        self._emit_publish(version, rows)
        return int(rows.size)

    def refresh_rows(self, rows: np.ndarray) -> None:
        """Publish a new version with ``rows`` re-uploaded from the host
        cache; the previous version's tensors stay as they were."""
        self._need_cache("a row refresh")
        rows = np.asarray(rows, dtype=np.int64).ravel()
        with self._pub_lock:
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
