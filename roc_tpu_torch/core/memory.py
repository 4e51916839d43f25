"""Memory placement policy (``roc_tpu/core/memory.py``): estimate a train
step's peak device bytes and choose a plan that fits.

The reference manages device-memory residency itself: a framebuffer
cache sized from ``maxHidden`` (``resourcemanager.cc:29-57``,
``load_task.cu:365-374``) backed by zero-copy host memory for whatever
does not fit (``types.cu:22-32``).  Here, as in the JAX package, the
policy picks a *plan* before the step runs, among:

- ``halo``: the one-shot all-gather (fast; every rank holds the gathered
  ``[V, H]`` matrix) or the ring (parallel/ring.py: O(V/P) rows, at the
  price of its tables);
- ``features``: input features resident on the device, or in host
  memory and streamed through the first layer (core/streaming.py);
- ``remat``: recompute activations in the backward instead of saving
  them (``torch.utils.checkpoint``, train/trainer.py).

:func:`choose_memory_plan` estimates each viable plan (cheapest compute
first) and returns the first that fits the budget.  The arithmetic is
the JAX package's, term for term, so both packages pick the same plan
for the same inputs; the factors model what that package's compiler
allocates and are not tuned to this card (what the card allocates is
printed beside them by chip_smoke.py).  The budget is the device's own:
:func:`detect_hbm_bytes` reads the card's total memory, or the host's
physical memory for the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

# Activation-liveness factors: a GCN-family layer keeps about this many
# [V_p, H] intermediates alive for the backward without remat (dropout
# out, linear out, two norms, aggregation out, relu out); with remat the
# layer boundaries survive, plus the saved aggregation outputs under the
# default save_aggregates policy.
_ACT_FACTOR_SAVED = 6
_ACT_FACTOR_REMAT_SAVE_AGG = 3   # layer boundaries + saved aggregates
_ACT_FACTOR_REMAT_FULL = 2       # layer boundaries only
# the usable share of the device's memory (allocator workspace, and the
# estimate is deliberately coarse)
_USABLE = 0.85
# the rows of one streamed feature block (core/streaming.py StreamedHead)
_STREAM_BLOCK_ROWS = 65536


def charged_table_bytes(aggr_impl: str, uses_attention: bool,
                        uses_max_aggregation: bool,
                        a_budget_bytes: Optional[int]) -> int:
    """The route-specific resident-table bytes the plan charges on top of
    the generic ``E*4`` term: the block-dense A-table, whose worst case
    is the planner's byte cap (``bdense_a_budget``).  Attention and
    MAX/MIN models never keep it (the resolver moves them off
    'bdense'); an uncapped budget charges 0."""
    keeps_bdense = (aggr_impl == "bdense"
                    and not uses_attention
                    and not uses_max_aggregation)
    return (a_budget_bytes or 0) if keeps_bdense else 0


def host_memory_bytes() -> int:
    """The host's physical memory, from ``os.sysconf``."""
    return int(os.sysconf("SC_PAGE_SIZE")) * int(os.sysconf("SC_PHYS_PAGES"))


def detect_hbm_bytes(device=None) -> int:
    """The budget of one device: the usable share of the card's total
    memory (``torch.cuda.mem_get_info``) for a CUDA ``device``, of the
    host's physical memory otherwise (the CPU's device memory is the
    host's)."""
    import torch
    device = torch.device(device) if device is not None else None
    if device is not None and device.type == "cuda":
        total = int(torch.cuda.mem_get_info(device)[1])
    else:
        total = host_memory_bytes()
    return int(total * _USABLE)


@dataclass
class MemoryPlan:
    """A chosen residency and exchange configuration, with its evidence."""
    halo: str            # "gather" | "ring"
    features: str        # "hbm" | "host"
    remat: bool
    fits: bool           # False: even the last plan is over budget
    est_bytes: int       # the chosen plan's estimate
    budget_bytes: int
    candidates: Dict[str, int]  # plan name -> estimated bytes
    reason: str

    @property
    def name(self) -> str:
        return (f"halo={self.halo} features={self.features} "
                f"remat={self.remat}")

    def echo(self) -> str:
        """The decision as one line (the event log adds the prefix)."""
        gib = 1024**3
        return (f"memory plan: {self.name} — est "
                f"{self.est_bytes / gib:.2f} GiB of "
                f"{self.budget_bytes / gib:.2f} GiB budget; {self.reason}")


def _act_factor(remat: bool, remat_policy: str) -> int:
    if not remat:
        return _ACT_FACTOR_SAVED
    return (_ACT_FACTOR_REMAT_FULL if remat_policy == "full"
            else _ACT_FACTOR_REMAT_SAVE_AGG)


def estimate_plan_bytes(num_nodes: int, num_edges: int,
                        layer_dims: Sequence[int], num_parts: int = 1,
                        dtype_bytes: int = 4, halo: str = "gather",
                        features: str = "hbm", remat: bool = False,
                        ring_padding: float = 1.7,
                        remat_policy: str = "save_aggregates",
                        extra_table_bytes: int = 0) -> int:
    """Coarse per-device peak estimate of one train step.

    ``layer_dims`` is the CLI layer spec (in-dim, hidden..., classes).
    Slightly pessimistic on purpose: the policy needs the plans' order,
    not exact bytes.  ``extra_table_bytes`` covers route-specific
    resident tables the generic ``E*4`` term misses
    (:func:`charged_table_bytes`)."""
    V_p = -(-num_nodes // num_parts)
    E_p = -(-num_edges // num_parts)
    b = dtype_bytes
    F = layer_dims[0]
    hiddens = list(layer_dims[1:])
    h_max = max(hiddens + [F])

    # replicated params + Adam m/v
    w = sum(layer_dims[i] * layer_dims[i + 1]
            for i in range(len(layer_dims) - 1))
    total = 3 * w * b

    # input features
    if features == "hbm":
        total += V_p * F * b
    else:
        total += _STREAM_BLOCK_ROWS * F * b  # one streamed block

    # edge tables: ~E_p int32 ids (+ row positions)
    total += E_p * 4 + V_p * 4 + extra_table_bytes
    if halo == "ring":
        total += int(2 * E_p * 4 * ring_padding)  # src+dst flat tables

    # live activations
    act = _act_factor(remat, remat_policy)
    act_bytes = sum(V_p * h * b * act for h in hiddens)
    if features == "hbm":
        # the first dropout's output is [V_p, F]
        act_bytes += V_p * F * b * (1 if remat else 2)
    total += act_bytes

    # halo transient: the gathered matrix, or two ring buffers
    if halo == "gather":
        total += num_parts * V_p * h_max * b
    else:
        total += 2 * V_p * h_max * b
    return total


def per_axis_plan_bytes(num_nodes: int, num_edges: int,
                        layer_dims: Sequence[int], parts: int = 1,
                        model: int = 1, dtype_bytes: int = 4,
                        halo: str = "gather", features: str = "hbm",
                        remat: bool = False,
                        remat_policy: str = "save_aggregates",
                        ring_padding: float = 1.7
                        ) -> Dict[str, Dict[str, int]]:
    """Per-component, per-mesh-axis attribution of one train step on an
    abstract ``(parts, model)`` mesh, the accounting of
    :func:`estimate_plan_bytes` (whose totals it reproduces at
    ``model=1``) with each component saying which axes divide it:
    params, Adam state and activations split over ``model``, vertex-scale
    tensors over ``parts``, index tables over ``parts`` only (the model
    axis replicates them).

    Returns ``{component: {"bytes", "parts_div", "model_div",
    "per_device", "replicated"}}`` plus a ``"total"`` row."""
    V_p = -(-num_nodes // max(parts, 1))
    E_p = -(-num_edges // max(parts, 1))
    b = dtype_bytes
    F = layer_dims[0]
    hiddens = list(layer_dims[1:])
    h_max = max(hiddens + [F])
    w = sum(layer_dims[i] * layer_dims[i + 1]
            for i in range(len(layer_dims) - 1))

    def comp(total: int, parts_div: int, model_div: int
             ) -> Dict[str, int]:
        per_dev = int(total) // max(parts_div * model_div, 1)
        rep = []
        if parts > 1 and parts_div == 1:
            rep.append("parts")
        if model > 1 and model_div == 1:
            rep.append("model")
        return {"bytes": int(total), "parts_div": parts_div,
                "model_div": model_div, "per_device": per_dev,
                "replicated": rep}

    out: Dict[str, Dict[str, int]] = {}
    out["params"] = comp(w * b, 1, model)
    out["opt_state"] = comp(2 * w * b, 1, model)
    if features == "hbm":
        out["features"] = comp(num_nodes * F * b, parts, model)
    else:
        out["features"] = comp(_STREAM_BLOCK_ROWS * F * b * parts, parts,
                               model)
    tab = E_p * 4 * parts + V_p * 4 * parts
    if halo == "ring":
        tab += int(2 * E_p * 4 * ring_padding) * parts
    out["tables"] = comp(tab, parts, 1)
    act = _act_factor(remat, remat_policy)
    act_bytes = sum(num_nodes * h * b * act for h in hiddens)
    if features == "hbm":
        act_bytes += num_nodes * F * b * (1 if remat else 2)
    out["activations"] = comp(act_bytes, parts, model)
    if halo == "gather":
        out["halo"] = comp(parts * V_p * h_max * b * parts, parts,
                           model)
    else:
        out["halo"] = comp(2 * V_p * h_max * b * parts, parts, model)
    total = sum(c["bytes"] for c in out.values())
    per_dev = sum(c["per_device"] for c in out.values())
    out["total"] = {"bytes": int(total), "per_device": int(per_dev),
                    "replicated": sorted({a for c in out.values()
                                          for a in c.get("replicated",
                                                         [])})}
    return out


def choose_memory_plan(num_nodes: int, num_edges: int,
                       layer_dims: Sequence[int], num_parts: int = 1,
                       dtype_bytes: int = 4,
                       hbm_bytes: Optional[int] = None,
                       head_streamable: bool = True,
                       remat_policy: str = "save_aggregates",
                       extra_table_bytes: int = 0,
                       device=None) -> MemoryPlan:
    """First fit over plans ordered cheapest compute first:
    gather/hbm -> gather/hbm+remat -> ring (P > 1, without and with
    remat) -> host-streamed features (P == 1, streamable heads).  The
    budget is ``hbm_bytes``, else :func:`detect_hbm_bytes` of
    ``device``.  If nothing fits, the last candidate comes back with
    ``fits=False`` (the caller proceeds; the echo says so)."""
    budget = (hbm_bytes if hbm_bytes is not None
              else detect_hbm_bytes(device))
    cands: List = [("gather/hbm", "gather", "hbm", False),
                   ("gather/hbm/remat", "gather", "hbm", True)]
    if num_parts > 1:
        cands += [("ring/hbm", "ring", "hbm", False),
                  ("ring/hbm/remat", "ring", "hbm", True)]
    elif head_streamable:
        cands += [("gather/host", "gather", "host", False),
                  ("gather/host/remat", "gather", "host", True)]
    est = {}
    for name, halo, feats, remat in cands:
        est[name] = estimate_plan_bytes(
            num_nodes, num_edges, layer_dims, num_parts, dtype_bytes,
            halo=halo, features=feats, remat=remat,
            remat_policy=remat_policy,
            # a ring run builds no A-table (its tables describe the whole
            # aggregation): charging it would push ring plans into remat
            extra_table_bytes=(extra_table_bytes
                               if halo == "gather" else 0))
    for name, halo, feats, remat in cands:
        if est[name] <= budget:
            return MemoryPlan(
                halo=halo, features=feats, remat=remat, fits=True,
                est_bytes=est[name], budget_bytes=budget,
                candidates=est,
                reason=f"first fit of {len(cands)} candidates")
    name, halo, feats, remat = cands[-1]
    return MemoryPlan(
        halo=halo, features=feats, remat=remat, fits=False,
        est_bytes=est[name], budget_bytes=budget, candidates=est,
        reason="NO plan fits the budget — proceeding with the smallest "
               "(estimates are pessimistic); expect allocator pressure")
