"""Rules over a recorded step's data movement and bytes
(``roc_tpu/analysis/hlo_lint.py``).

The JAX package reads the optimized HLO text and ``cost_analysis`` of
the compiled train step.  The port compiles no step: it reads the
recorded one (analysis/step_trace.py ``StepTrace``), where eager torch
fuses nothing, so an "unfused copy" is a pure copy op.

- [hlo-large-copy] a pure data-movement op outside a kernel region that
  materializes at least ``V * F`` elements: ``clone`` (``contiguous``
  dispatches it), ``copy_`` into a buffer the step just allocated, a
  ``_to_copy`` that keeps the dtype (a layout or device move), each a
  full memory round trip; one whose source is a strided view (a
  transpose or permute) is the materialized ``transpose``.  The keys are
  the JAX package's, in the HLO text's spelling (``copy|f32[256,48]``).
- [hlo-bytes-model] the recording's bytes (every op's reads and writes;
  a kernel region its inputs and output) past ``factor`` (32) x the
  memory model's estimate (train/trainer.py ``Trainer.modeled_bytes``):
  only an order-of-magnitude blow-up (a ``[V, V]`` materialization, a
  gather that lost its kernel) is a finding.
"""

from __future__ import annotations

from typing import List, Optional

from .findings import Finding
from .step_trace import ALLOC_OPS, HLO_DTYPE


def _hlo(meta) -> str:
    """``f32[256,48]``: a tensor in the HLO text's spelling."""
    dims = ",".join(str(int(d)) for d in meta.shape)
    return f"{HLO_DTYPE.get(meta.dtype, meta.dtype)}[{dims}]"


def check_large_copy(unit: str, trace, copy_min_elems: int
                     ) -> List[Finding]:
    """Flag each pure copy (module docstring) of at least
    ``copy_min_elems`` elements outside a kernel region."""
    out: List[Finding] = []
    for e in trace.entries:
        if e.kernel or not e.ins:
            continue
        if e.name == "clone" and e.outs:
            src, dst = e.ins[0], e.outs[0]
        elif e.name == "_to_copy" and e.outs and \
                e.ins[0].dtype == e.outs[0].dtype:
            src, dst = e.ins[0], e.outs[0]
        elif e.name == "copy_" and len(e.ins) >= 2 and e.src and \
                e.src[0] is not None and \
                trace.entries[e.src[0][0]].op in ALLOC_OPS and \
                e.ins[0].dtype == e.ins[1].dtype:
            src, dst = e.ins[1], e.ins[0]
        else:
            continue
        op = "copy" if src.contiguous else "transpose"
        n = dst.numel
        if n >= copy_min_elems:
            out.append(Finding(
                "hlo-large-copy", unit,
                f"un-fused {op} ({e.op}) materializes {_hlo(dst)} ({n} "
                f"elems >= activation scale {copy_min_elems}) — a full "
                f"memory round trip of a pure copy",
                key=f"{op}|{_hlo(dst)}"))
    return out


def check_bytes_model(unit: str, bytes_accessed: Optional[float],
                      modeled_bytes: Optional[int],
                      factor: float = 32.0) -> List[Finding]:
    """Flag a step whose recorded bytes exceed ``factor`` x the memory
    model's estimate (the JAX package's rule and message)."""
    if not bytes_accessed or not modeled_bytes:
        return []
    if bytes_accessed <= factor * modeled_bytes:
        return []
    return [Finding(
        "hlo-bytes-model", unit,
        f"bytes accessed {bytes_accessed:.3g} exceeds {factor:g}x the "
        f"core/memory.py estimate ({modeled_bytes} B) — the step is "
        f"moving far more data than the plan modeled",
        key="bytes-model")]
