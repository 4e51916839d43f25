"""The serving runtime (``roc_tpu/serve/predictor.py``), full-graph
backend: every dispatch runs the whole-graph forward on the model's
device (the same aggregation route and graph context serving was built
with) and gathers the queried rows there.

Request batch sizes pad to :data:`SERVE_BUCKETS`, so a dispatch always
has one of a few shapes; padded slots query row 0 and their logits are
dropped.  The forward runs under ``torch.inference_mode``, in the
config's compute dtype (bf16 in the 'mixed' and 'bfloat16' modes: a bf16
table and the kernels' bf16 instances); :meth:`Predictor.query` returns
fp32 numpy logits in every mode.  The forward is deterministic in every
dtype, so a row served in a coalesced dispatch has the bits it has
served alone.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..train.trainer import cast_floats, compute_dtype_of

# The padded microbatch sizes a server dispatches.
SERVE_BUCKETS: Tuple[int, ...] = (1, 8, 64, 512)


class TableVersion(NamedTuple):
    """One published serving table: a version counter and the device
    tensor every dispatch under that version reads (for the full
    backend, the feature matrix)."""
    version: int
    table: Any


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; requests past the largest bucket are split
    into largest-bucket chunks by the caller."""
    for b in buckets:
        if n <= b:
            return b
    return max(buckets)


class Predictor:
    """Frozen-params query engine over the full-graph forward.  Build it
    with :func:`roc_tpu_torch.serve.export.build_predictor`."""

    def __init__(self, model, config, params, backend: str,
                 buckets: Sequence[int], dataset=None, gctx=None,
                 num_classes: Optional[int] = None, device=None):
        if backend != "full":
            raise NotImplementedError(
                f"serve backend {backend!r} is not ported; only 'full'")
        if dataset is None or gctx is None:
            raise ValueError("full backend needs dataset + gctx")
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or any(b < 1 for b in self.buckets):
            raise ValueError(f"bad serve buckets {buckets!r}")
        self.model = model
        self.config = config
        self.backend = backend
        self.device = torch.device(device)
        self.compute = compute_dtype_of(config)
        self.params = cast_floats(
            {k: v.detach().to(self.device) for k, v in params.items()},
            self.compute)
        self.num_nodes = dataset.graph.num_nodes
        self.num_classes = num_classes
        self.gctx = gctx
        self.pad_id = 0   # any valid row; padded outputs are discarded
        feats = torch.as_tensor(np.asarray(dataset.features),
                                dtype=self.compute).to(self.device)
        self._published = TableVersion(0, feats)

    def published(self) -> TableVersion:
        """A consistent snapshot of the current table version; a
        microbatch captures it once and is served from it."""
        return self._published

    def query_device(self, ids_padded: torch.Tensor,
                     pub: Optional[TableVersion] = None) -> torch.Tensor:
        """One padded-bucket dispatch: the device logits ``[bucket, C]``
        of rows ``ids_padded`` (an int tensor on the model's device whose
        length is a bucket)."""
        b = int(ids_padded.shape[0])
        if b not in self.buckets:
            raise ValueError(f"ids length {b} is not a bucket "
                             f"{self.buckets}")
        if pub is None:
            pub = self._published
        with torch.inference_mode():
            logits = self.model.apply(self.params, pub.table, self.gctx,
                                      train=False)
            return logits.index_select(0, ids_padded)

    def query(self, node_ids,
              pub: Optional[TableVersion] = None) -> np.ndarray:
        """Pad to the smallest fitting bucket, dispatch, fetch, slice;
        ids past the largest bucket go in largest-bucket chunks.  The
        microbatch server (serve/server.py) coalesces concurrent
        requests into one such call."""
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
