"""Rules over the recorded programs of the port's steps
(``roc_tpu/analysis/jaxpr_lint.py``).

The JAX package walks the ClosedJaxpr of each jitted step.  The port's
steps run eagerly; what they dispatch is recorded as a
:class:`~roc_tpu_torch.analysis.step_trace.StepTrace` (one entry per
aten op, each hand-written kernel one opaque ``kernel:<instance>``
entry), and these rules read that in the jaxpr's place.  Each lint unit
(:class:`StepUnit`) is one recorded step plus the static context a rule
needs: the compute dtype, the dataset's ``[V, F]`` scale, the halo, the
donation threshold, the bound of integer inputs.  Rule names and finding
keys are the JAX package's (``upcast|bfloat16[256, 48]``), so
``--select`` and the baselines name one invariant in both packages.

- [jaxpr-f32-upcast] a ``_to_copy`` (or ``copy_``) from bf16 to fp32 of
  at least ``vf_elems`` elements under a bf16 compute dtype, outside a
  kernel region (the kernels upcast in registers; their plain versions'
  fp32 math on the CPU is the kernel's, not the step's);
- [jaxpr-host-callback] a device-to-host sync inside the step:
  ``_local_scalar_dense`` (``.item()``, ``bool(t)``), ``nonzero``,
  ``masked_select``, ``is_nonzero``, ``equal``, or a copy of a device
  tensor to the CPU (the last one only where the step runs on a card:
  the CPU rig has no device to copy from).  The key names the JAX
  primitive each stands for (:data:`SYNC_PRIMITIVE`);
- [jaxpr-non-donated] a leaf at a position the unit donates
  (train/trainer.py ``STEP_DONATE``: the params and Adam moments) of at
  least ``donate_min_bytes`` that the step does not rewrite in place:
  its slot holds another tensor or storage afterwards, or its version
  counter did not move.  The port's donation is an update in place
  (train/optimizer.py ``adam_update`` writes with ``copy_``); the
  temporaries a step makes and drops (its gradients) are out of scope;
- [jaxpr-collective-materialize] over the unit's collectives
  (parallel/distributed.py ``record_collectives``): an all-reduce of a
  ``[V, F]``-scale operand, any all-gather under ``halo='ring'``, an
  all-gather landing at least twice the whole-region ``[V, F]``;
- [jaxpr-int32-overflow] a static bound propagated over the recorded
  integer ops (``mul``, ``add``, ``sub``, ``sum``, ``cumsum``, ``mm``,
  ``arange``; views and gathers pass a bound through): a result whose
  bound reaches its dtype's range, or a narrowing cast of such a value.
  Integer tensors from outside the recording are bounded by
  ``index_bound`` (default V) and Python numbers are exact.

The thresholds are scale-relative, as in the JAX package: the same rules
bite on the 256-node CPU rig and at Reddit's shape on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .collective_lint import primitive
from .findings import Finding

# the device-to-host syncs, by the JAX primitive each stands for: a value
# read back to steer the host (a pure callback's round trip) or a tensor
# handed to the host (an io callback's)
SYNC_PRIMITIVE = {"_local_scalar_dense": "pure_callback",
                  "is_nonzero": "pure_callback",
                  "equal": "pure_callback",
                  "nonzero": "pure_callback",
                  "masked_select": "pure_callback",
                  "_to_copy": "io_callback", "copy_": "io_callback"}

_COLLECTIVE_GATHERS = ("all_gather",)


@dataclass
class StepUnit:
    """One recorded step under lint: the fields of the JAX package's
    ``JaxprUnit`` with ``trace`` (a ``StepTrace``) in place of its jaxpr,
    and ``donate``, the argument positions the step rewrites in place
    (the JAX jit's ``donate_argnums``).  ``vf_elems`` is the per-rank
    activation scale on a partitioned unit (V/P * F), whose whole-region
    gather is ``mesh_parts * vf_elems``."""

    name: str
    trace: Any
    compute_dtype: str = "float32"
    num_nodes: int = 0
    vf_elems: int = 0
    halo: str = "gather"
    donate_min_bytes: int = 1 << 20
    index_bound: Optional[int] = None
    mesh_parts: int = 1
    donate: Tuple[int, ...] = ()
    detail: Dict[str, Any] = field(default_factory=dict)

    @property
    def unit(self) -> str:
        return f"jaxpr:{self.name}"


def _ops(u: StepUnit):
    """The unit's entries outside kernel regions (a region is one
    entry, never an aten op)."""
    return [e for e in u.trace.entries if not e.kernel]


def check_f32_upcast(u: StepUnit) -> List[Finding]:
    """[jaxpr-f32-upcast] see the module docstring."""
    out: List[Finding] = []
    if u.compute_dtype != "bfloat16" or not u.vf_elems:
        return out
    for e in _ops(u):
        if e.name == "_to_copy" and e.ins and e.outs:
            src, dst = e.ins[0], e.outs[0]
        elif e.name == "copy_" and len(e.ins) >= 2:
            src, dst = e.ins[1], e.ins[0]
        else:
            continue
        if src.dtype != "bfloat16" or dst.dtype != "float32":
            continue
        if src.numel >= u.vf_elems:
            out.append(Finding(
                "jaxpr-f32-upcast", u.unit,
                f"bf16 -> f32 upcast of activation-scale tensor "
                f"{src.render()} (>= V*F = {u.vf_elems} elems) in a "
                f"bf16-configured path ({e.op})",
                key=f"upcast|{src.render()}"))
    return out


def sync_entries(u: StepUnit) -> List[Any]:
    """The unit's entries that sync the host on the device: the ops of
    :data:`SYNC_PRIMITIVE`, a copy only from a card to the CPU."""
    got = []
    for e in _ops(u):
        if e.name not in SYNC_PRIMITIVE:
            continue
        if e.name == "_to_copy":
            if not (e.ins and e.outs and e.ins[0].device != "cpu"
                    and e.outs[0].device == "cpu"):
                continue
        elif e.name == "copy_":
            if not (len(e.ins) >= 2 and e.ins[0].device == "cpu"
                    and e.ins[1].device != "cpu"):
                continue
        got.append(e)
    return got


def check_host_callback(u: StepUnit) -> List[Finding]:
    """[jaxpr-host-callback] see the module docstring: one finding per
    sync (the driver dedupes by key)."""
    out: List[Finding] = []
    for e in sync_entries(u):
        prim = SYNC_PRIMITIVE[e.name]
        out.append(Finding(
            "jaxpr-host-callback", u.unit,
            f"host callback primitive '{prim}' inside the step: {e.op} "
            f"is a device->host round trip per step",
            key=f"callback|{prim}", detail={"op": e.op}))
    return out


def check_non_donated(u: StepUnit) -> List[Finding]:
    """[jaxpr-non-donated] see the module docstring."""
    out: List[Finding] = []
    for leaf in u.trace.leaves:
        if leaf.arg not in u.donate:
            continue
        nbytes = leaf.meta.nbytes
        if nbytes < u.donate_min_bytes:
            continue
        if leaf.same and leaf.versions > 0:
            continue
        why = ("its slot holds another tensor afterwards" if not leaf.same
               else "the step did not write it")
        out.append(Finding(
            "jaxpr-non-donated", u.unit,
            f"arg {leaf.pos} ({leaf.meta.render()}, {nbytes} B) is "
            f"donated but not rewritten in place ({why}) — its memory "
            f"is held twice across the step; update it in place",
            key=f"nondonated|{leaf.pos}|{leaf.meta.render()}"))
    return out


def check_collective_materialize(u: StepUnit) -> List[Finding]:
    """[jaxpr-collective-materialize] see the module docstring."""
    out: List[Finding] = []
    if not u.vf_elems:
        return out
    for c in u.trace.collectives:
        name = primitive(c)
        shape = [int(d) for d in c["shape"]]
        n = 1
        for d in shape:
            n *= d
        s = f"{c['dtype']}{shape}"
        if c["kind"] == "all_reduce" and name == "psum":
            if n >= u.vf_elems:
                out.append(Finding(
                    "jaxpr-collective-materialize", u.unit,
                    f"psum of activation-scale tensor {s} (>= V*F = "
                    f"{u.vf_elems}) — an implicit cross-shard "
                    f"materialization; the symmetric aggregation avoids "
                    f"this", key=f"psum|{s}"))
        elif name in _COLLECTIVE_GATHERS:
            gshape = [int(c["size"]) * shape[0]] + shape[1:]
            n = n * int(c["size"])
            gs = f"{c['dtype']}{gshape}"
            whole_region = u.vf_elems * max(u.mesh_parts, 1)
            if u.halo == "ring" and n >= u.vf_elems:
                out.append(Finding(
                    "jaxpr-collective-materialize", u.unit,
                    f"{name} materializes {gs} under halo='ring' — the "
                    f"ring exists to keep per-device peak at O(V/P * F)",
                    key=f"ring-gather|{name}|{gs}"))
            elif n >= 2 * whole_region:
                out.append(Finding(
                    "jaxpr-collective-materialize", u.unit,
                    f"{name} materializes {gs} — larger than the designed "
                    f"whole-region [V, F] gather ({whole_region} elems)",
                    key=f"gather|{name}|{gs}"))
    return out


def _int_limit(dtype: str) -> Optional[int]:
    return {"int32": 2 ** 31, "uint32": 2 ** 32, "int16": 2 ** 15,
            "uint16": 2 ** 16}.get(dtype)


def _is_int(dtype: str) -> bool:
    return "int" in dtype


# ops whose result's bound is their first tensor operand's
_PASS = {"view", "_unsafe_view", "reshape", "t", "transpose", "permute",
         "expand", "squeeze", "unsqueeze", "slice", "select", "alias",
         "as_strided", "detach", "clone", "contiguous", "index_select",
         "gather", "index", "flip", "roll", "narrow", "repeat",
         "repeat_interleave", "lift_fresh", "_reshape_alias", "unfold",
         "masked_fill", "sort", "abs", "neg", "clamp", "clamp_min",
         "clamp_max", "fill_", "copy"}
# the JAX primitive of each integer arithmetic op (the keys' names)
_ARITH = {"mul": "mul", "add": "add", "sub": "sub", "rsub": "sub",
          "sum": "reduce_sum", "cumsum": "cumsum", "mm": "dot_general",
          "matmul": "dot_general", "bmm": "dot_general",
          "mul_": "mul", "add_": "add", "sub_": "sub"}


def check_int32_overflow(u: StepUnit) -> List[Finding]:
    """[jaxpr-int32-overflow] see the module docstring."""
    out: List[Finding] = []
    default = (u.index_bound if u.index_bound is not None
               else max(u.num_nodes, 1))
    bounds: Dict[Tuple[int, int], Optional[int]] = {}
    entries = u.trace.entries
    for idx, e in enumerate(entries):
        def bound_in(i: int) -> Optional[int]:
            if i >= len(e.ins):
                return None
            s = e.src[i] if i < len(e.src) else None
            if s is None:
                return default if _is_int(e.ins[i].dtype) else None
            return bounds.get(s)

        def operand(k: int) -> Optional[int]:
            if k >= len(e.operands):
                return None
            kind, v = e.operands[k]
            if kind == "n":
                try:
                    return abs(int(v))
                except (TypeError, ValueError, OverflowError):
                    return None
            if kind == "t":
                return bound_in(v)
            return None

        if not e.outs:
            continue
        odt = e.outs[0].dtype
        is_int = _is_int(odt)
        name = e.name
        res: Optional[int] = None
        arith = False
        if e.kernel:
            res = None
        elif name == "arange":
            n = e.outs[0].numel
            nums = [v for kind, v in e.operands if kind == "n"]
            start = nums[0] if len(nums) >= 2 else 0
            step = nums[2] if len(nums) >= 3 else 1
            try:
                res = max(abs(int(start)),
                          abs(int(start + (n - 1) * step))) if n else 0
            except (TypeError, ValueError, OverflowError):
                res = None
        elif name in ("zeros", "zeros_like", "new_zeros"):
            res = 0
        elif name in ("ones", "ones_like", "new_ones"):
            res = 1
        elif name in ("full", "full_like", "new_full", "scalar_tensor"):
            nums = [v for kind, v in e.operands if kind == "n"]
            if "fill_value" in e.kw:
                nums.append(e.kw["fill_value"])
            try:
                res = abs(int(nums[-1])) if nums else None
            except (TypeError, ValueError, OverflowError):
                res = None
        elif name in _ARITH and is_int:
            arith = True
            prim = _ARITH[name]
            a, b = operand(0), operand(1)
            if prim in ("mul", "dot_general"):
                if a is not None and b is not None:
                    res = a * b
                    if prim == "dot_general":
                        res *= max(int(e.ins[0].shape[-1]), 1)
            elif prim in ("add", "sub"):
                alpha = e.kw.get("alpha", 1)
                if a is not None and b is not None:
                    try:
                        res = a + b * abs(int(alpha))
                    except (TypeError, ValueError):
                        res = None
            else:       # reduce_sum / cumsum: every element at its bound
                if a is not None:
                    res = a * max(e.ins[0].numel, 1)
        elif name in ("max", "min", "maximum", "minimum", "cat", "stack",
                      "where"):
            start = 1 if name == "where" else 0
            known = [bound_in(i) for i in range(start, len(e.ins))]
            known = [b for b in known if b is not None]
            res = max(known) if known else None
        elif name in _PASS:
            res = operand(0)
        elif name in ("_to_copy", "copy_"):
            res = bound_in(1 if name == "copy_" else 0)
            dst = e.ins[0].dtype if name == "copy_" else odt
            lim = _int_limit(dst) if _is_int(dst) else None
            if res is not None and lim and res >= lim:
                meta = e.ins[0] if name == "copy_" else e.outs[0]
                out.append(Finding(
                    "jaxpr-int32-overflow", u.unit,
                    f"narrowing convert to {dst} truncates: static bound "
                    f"{res} >= {lim}",
                    key=f"narrow|{dst}|{meta.render()}"))
        if arith and res is not None:
            lim = _int_limit(odt)
            if lim and res >= lim:
                prim = _ARITH[name]
                out.append(Finding(
                    "jaxpr-int32-overflow", u.unit,
                    f"{prim} on {odt} has static bound {res} >= {lim} — "
                    f"index arithmetic overflows; compute in int64 (or "
                    f"rescale) before narrowing",
                    key=f"overflow|{prim}|{odt}|{e.outs[0].render()}"))
        for k in range(len(e.outs)):
            bounds[(idx, k)] = res
    return out


JAXPR_RULES = {
    "jaxpr-f32-upcast": check_f32_upcast,
    "jaxpr-host-callback": check_host_callback,
    "jaxpr-non-donated": check_non_donated,
    "jaxpr-collective-materialize": check_collective_materialize,
    "jaxpr-int32-overflow": check_int32_overflow,
}


def run_jaxpr_lint(units: List[StepUnit],
                   select: Optional[List[str]] = None) -> List[Finding]:
    findings: List[Finding] = []
    for unit in units:
        for name, rule in JAXPR_RULES.items():
            if select is not None and name not in select:
                continue
            findings.extend(rule(unit))
    return findings
