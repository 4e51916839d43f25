"""The recorder of a step's program: the port's counterpart of
``jax.make_jaxpr`` as ``roc_tpu/analysis/driver.py`` uses it.

The JAX package lints the jaxpr of each jitted step.  The port runs its
steps eagerly, so its program is the sequence of aten ops a step
dispatches.  :func:`record` runs a callable once, as it would run, under
a ``TorchDispatchMode`` (_dispatch.py; the mode
``torch.utils.flop_counter.FlopCounterMode`` is built on) and returns a
:class:`StepTrace`: one :class:`Entry` per aten op, in dispatch order,
with its name, the shape, dtype and device of each input and output
tensor (dtypes by the JAX package's names, ``bfloat16[64, 32]``), the
bytes it reads and writes, whether it writes an argument in place, and
which entry produced each input.

- **Kernel regions.**  A hand-written kernel is one opaque entry,
  ``kernel:<instance>`` (kernels/_build.py ``instance_name``), on both
  devices: each wrapper runs its plain version (the CPU) or its launch
  (the card) inside ``_build.kernel_region``; the recorder keeps nothing
  of what happens inside and records the region's inputs and output at
  its end.  So the plain versions' fp32 math on the CPU is not taken for
  the step's, and the card's ``ctypes`` launch, which the dispatcher
  never sees, is seen.
- **Threads.**  A train step's backward runs on the autograd engine's
  device thread on the card; the mode follows it there (autograd
  carries the dispatch mode to its threads) and entries from every
  thread are appended under one lock.
- **No tensor is kept alive.**  A tensor is known by a weak reference
  (``torch.utils.weak.WeakIdKeyDictionary``), never by its address: the
  caching allocator hands one address to many tensors within a step.
- **Recording changes no path.**  Every op runs as it would; the mode
  only reads shapes.  A recorded step's results are bit-equal to an
  unrecorded one's.

With ``args_of`` (the step slot's arguments, as ``Trainer.step_args``
gives them), the leaves are read before and after the call: whether each
is still the same tensor with its storage and how far its version
counter moved, the port's form of buffer donation
(analysis/jaxpr_lint.py ``jaxpr-non-donated``).  The collectives the
call made (parallel/distributed.py ``record_collectives``) ride along in
``collectives``.

Nothing here imports torch at module level; :func:`record` does.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# bytes per element by the JAX package's dtype names
ITEMSIZE = {"float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
            "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
            "bool": 1, "complex64": 8, "complex128": 16,
            "float8_e4m3fn": 1, "float8_e5m2": 1, "uint16": 2,
            "uint32": 4, "uint64": 8}

# the HLO text's short dtype names (hlo-large-copy keys)
HLO_DTYPE = {"float64": "f64", "float32": "f32", "float16": "f16",
             "bfloat16": "bf16", "int64": "s64", "int32": "s32",
             "int16": "s16", "int8": "s8", "uint8": "u8", "bool": "pred",
             "uint16": "u16", "uint32": "u32", "uint64": "u64"}

# the aten ops that only allocate (their output's contents are unset)
ALLOC_OPS = ("empty.memory_format", "empty_like.default",
             "new_empty.default", "empty_strided.default",
             "new_empty_strided.default")


def dtype_name(dtype) -> str:
    """``torch.bfloat16`` -> ``'bfloat16'`` (the JAX package's name)."""
    s = str(dtype)
    return s[len("torch."):] if s.startswith("torch.") else s


@dataclass(frozen=True)
class TensorMeta:
    """What the recording keeps of a tensor: its shape, dtype (the JAX
    package's name), device type and whether it is contiguous."""

    shape: Tuple[int, ...]
    dtype: str
    device: str = "cpu"
    contiguous: bool = True

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= int(d)
        return n

    @property
    def nbytes(self) -> int:
        return self.numel * ITEMSIZE.get(self.dtype, 4)

    def render(self) -> str:
        """``bfloat16[64, 32]``, the JAX package's ``_shape_str``."""
        return f"{self.dtype}{list(self.shape)}"


@dataclass
class Entry:
    """One op of a recorded step.

    ``op``: the aten overload without its namespace (``mul.Tensor``,
    ``_to_copy.default``), or ``kernel:<instance>`` for a kernel region.
    ``ins``/``outs``: the tensors read and produced; ``src[i]`` the
    ``(entry, output)`` that produced ``ins[i]`` in this recording, None
    for a tensor from outside it.  ``operands``: the positional
    arguments, each ``('t', i)`` (``ins[i]``), ``('n', value)`` (a
    number) or ``('x', None)``; ``kw`` the keyword arguments that are
    numbers, dtypes or None.  ``read``/``write``: bytes (0 for a view;
    an allocation writes nothing).  ``inplace``: the op writes one of
    its arguments.  ``launches``: for a kernel region, the launches it
    made (1 for its plain version's call).  ``thread``: 'main', or the
    thread it ran on."""

    op: str
    ins: Tuple[TensorMeta, ...]
    outs: Tuple[TensorMeta, ...]
    src: Tuple[Optional[Tuple[int, int]], ...] = ()
    operands: Tuple[Tuple[str, Any], ...] = ()
    kw: Dict[str, Any] = field(default_factory=dict)
    read: int = 0
    write: int = 0
    inplace: bool = False
    view: bool = False
    launches: int = 1
    thread: str = "main"

    @property
    def kernel(self) -> bool:
        return self.op.startswith("kernel:")

    @property
    def name(self) -> str:
        """The op without its overload (``mul``, ``_to_copy``)."""
        return self.op.split(".", 1)[0]


@dataclass
class LeafState:
    """One leaf of the step's arguments: its flat position, its tensor
    before the call, and after it whether the slot holds the same tensor
    on the same storage and how far its version counter moved."""

    pos: int
    meta: TensorMeta
    arg: int = 0
    same: bool = True
    versions: int = 0
    after_shape: Tuple[int, ...] = ()


@dataclass
class StepTrace:
    """A recorded call (:func:`record`)."""

    entries: List[Entry] = field(default_factory=list)
    leaves: List[LeafState] = field(default_factory=list)
    collectives: List[Dict[str, Any]] = field(default_factory=list)
    result: Any = None

    def kernels(self) -> List[str]:
        """The kernel instances launched in the recording's regions,
        sorted and distinct (kernels/_build.py ``instances_since``'s
        form)."""
        return sorted(set(self.kernel_entries()))

    def kernel_entries(self) -> List[str]:
        """Each region's instance once per launch (once per plain call),
        in order: the recording's counterpart of the kernels' tally."""
        return [e.op[len("kernel:"):] for e in self.entries if e.kernel
                for _ in range(e.launches)]

    @property
    def bytes_total(self) -> int:
        """Bytes read plus bytes written over every entry (a kernel
        region counts its inputs and its output)."""
        return sum(e.read + e.write for e in self.entries)

    def large(self, min_elems: int) -> Dict[Tuple[Tuple[int, ...], str],
                                            int]:
        """``{(shape, dtype): outputs}`` of every non-view output of at
        least ``min_elems`` elements (the sharding ledger's activation
        rows)."""
        out: Dict[Tuple[Tuple[int, ...], str], int] = {}
        for e in self.entries:
            if e.view:
                continue
            for m in e.outs:
                if m.numel >= min_elems:
                    k = (tuple(m.shape), m.dtype)
                    out[k] = out.get(k, 0) + 1
        return out


def _leaf_states(args) -> List[Tuple[Any, int, int, int]]:
    """``(tensor, argument, version, storage address)`` of each leaf of
    the argument tuple ``args`` (obs/compile_watch.py ``tree_leaves``'
    order)."""
    from ..obs.compile_watch import tree_leaves
    out = []
    for a, arg in enumerate(args):
        for t in tree_leaves(arg):
            try:
                ptr = t.untyped_storage().data_ptr()
            except (AttributeError, RuntimeError):
                ptr = None
            out.append((t, a, int(getattr(t, "_version", 0)), ptr))
    return out


def record(fn: Callable[..., Any], *args: Any,
           args_of: Optional[Callable[[], Any]] = None,
           **kwargs: Any) -> StepTrace:
    """Run ``fn(*args, **kwargs)`` once under the recorder and return its
    :class:`StepTrace` (the call's return value in ``result``).
    ``args_of``: the step's arguments, read before and after the call for
    ``leaves``.  Nests in an outer ``record_collectives`` (the
    collective lint's): the calls made inside land in both."""
    import weakref

    from ..obs.compile_watch import leaf_struct
    from ._dispatch import OpRecorder
    from ..parallel import distributed as D
    before = _leaf_states(args_of()) if args_of is not None else []
    refs = [(weakref.ref(t), a, v, p) for t, a, v, p in before]
    metas = []
    for t, _, _, _ in before:
        dt, dims, _ = leaf_struct(t)
        metas.append(TensorMeta(tuple(dims), dt,
                                getattr(getattr(t, "device", None),
                                        "type", "cpu")))
    del before
    outer = D._recording
    ctx = (D.record_collectives() if outer is None
           else contextlib.nullcontext(outer))
    rec = OpRecorder()
    with ctx as calls:
        n0 = len(calls)
        with rec:
            result = fn(*args, **kwargs)
        coll = [dict(c) for c in calls[n0:]]
    trace = StepTrace(entries=rec.entries, collectives=coll, result=result)
    if args_of is not None:
        after = _leaf_states(args_of())
        for i, ((ref, a, v0, p0), meta) in enumerate(zip(refs, metas)):
            t, _, v1, p1 = after[i] if i < len(after) else (None, a, 0,
                                                              None)
            same = t is not None and ref() is t and p1 == p0
            shape = (tuple(int(d) for d in t.shape) if t is not None
                     else ())
            trace.leaves.append(LeafState(i, meta, a, same,
                                          v1 - v0 if same else 0, shape))
    return trace
