"""Building a live predictor (``roc_tpu/serve/export.py`` resolve_backend
and build_predictor), for the full-graph backend.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from ..train.trainer import (make_graph_context, resolve_device,
                             resolve_fuse)
from .predictor import SERVE_BUCKETS, Predictor


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


def build_predictor(model, dataset, config, params=None,
                    backend: str = "auto",
                    buckets: Sequence[int] = SERVE_BUCKETS,
                    device=None) -> Predictor:
    """Resolve the model (fuse rule) and build a live Predictor on
    ``device`` (the card unless the caller passes another; with no card
    and no ``device`` it raises).  ``params=None`` draws fresh Glorot
    weights from a generator seeded with ``config.seed``."""
    device = resolve_device(device)
    model = resolve_fuse(model, config)
    backend, flavor = resolve_backend(model, backend)
    if backend != "full":
        raise NotImplementedError(
            f"serve backend {backend!r}/{flavor} is not ported; the "
            "port serves backend='full'")
    if params is None:
        gen = torch.Generator(device=device).manual_seed(config.seed)
        params = model.init_params(gen, dtype=config.dtype, device=device)
    gctx = make_graph_context(dataset, config.aggr_impl,
                              symmetric=config.symmetric, device=device,
                              chunk=config.chunk)
    return Predictor(model, config, params, backend, buckets,
                     dataset=dataset, gctx=gctx,
                     num_classes=_num_classes(model), device=device)
