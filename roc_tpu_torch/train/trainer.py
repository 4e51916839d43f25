"""The part of ``roc_tpu/train/trainer.py`` that serving reads: the config,
the fuse rule, the graph context and the dtype helpers.  The epoch loop
is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from ..core.ell import ell_from_graph
from ..core.graph import Dataset, check_symmetric
from ..models.builder import AGGR_IMPLS, GraphContext, Model
from ..ops.norm import inv_sqrt_degree


@dataclass
class TrainConfig:
    """The serving subset of the JAX package's ``TrainConfig``.

    aggr_impl: 'cuda' (the hand-written kernels, the JAX package's
      'pallas') or 'ell' (the plain PyTorch ELL sum).
    aggr_fuse: 'auto' | 'on' | 'off', see :func:`resolve_fuse`.
    symmetric: None = check the graph; recorded on the graph context.
    """
    seed: int = 1
    aggr_impl: str = "cuda"
    aggr_fuse: str = "auto"
    symmetric: Optional[bool] = None
    dtype: torch.dtype = torch.float32
    compute_dtype: Optional[torch.dtype] = None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for another.  Raises when no card is present and none was
    asked for; it never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                           "the CPU")
    return torch.device("cuda")


def resolve_fuse(model: Model, config: TrainConfig) -> Model:
    """'off' leaves the model alone; 'auto'/'on' rewrite its fusable
    ``norm -> aggregate -> norm [-> relu]`` chains into fused ops.
    Returns the ORIGINAL object when nothing fused."""
    if config.aggr_fuse == "off":
        return model
    if config.aggr_fuse not in ("auto", "on"):
        raise ValueError(f"unknown aggr_fuse {config.aggr_fuse!r}; "
                         "expected 'auto', 'on', or 'off'")
    fused = model.fuse_norm_aggregate()
    if fused.num_fused_aggregates() <= model.num_fused_aggregates():
        return model
    return fused


def compute_dtype_of(config: TrainConfig) -> torch.dtype:
    """``compute_dtype`` when set (mixed precision), else ``dtype``."""
    return (config.compute_dtype if config.compute_dtype is not None
            else config.dtype)


def cast_floats(params: Dict[str, torch.Tensor],
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Floating-point entries cast to ``dtype``; others pass through."""
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in params.items()}


def make_graph_context(dataset: Dataset, aggr_impl: str = "cuda",
                       symmetric: Optional[bool] = None,
                       device=None) -> GraphContext:
    """Single-device GraphContext with the ELL tables (core/ell.py) on
    ``device`` (the card unless ``device`` says otherwise)."""
    if aggr_impl not in AGGR_IMPLS:
        raise ValueError(f"aggr_impl {aggr_impl!r} is not ported; "
                         f"expected one of {AGGR_IMPLS}")
    device = resolve_device(device)
    g = dataset.graph
    table = ell_from_graph(g.row_ptr, g.col_idx, g.num_nodes)

    def dev(a):
        return torch.from_numpy(a).to(device)

    in_degree = dev(g.in_degree)
    return GraphContext(
        in_degree=in_degree,
        inv_sqrt_deg=inv_sqrt_degree(in_degree),
        num_rows=g.num_nodes,
        ell_idx=tuple(dev(a[0]) for a in table.idx),
        ell_row_pos=dev(table.row_pos[0]),
        ell_row_id=tuple(dev(a[0]) for a in table.row_id),
        aggr_impl=aggr_impl,
        symmetric=(check_symmetric(g) if symmetric is None
                   else bool(symmetric)))
