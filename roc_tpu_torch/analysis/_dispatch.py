"""The dispatch-level recorder behind step_trace.py ``record``:
a ``TorchDispatchMode`` that appends one ``Entry`` per aten op it sees
and one per kernel region (kernels/_build.py ``kernel_region``) that
ends while it records.

The mode runs every op as the dispatcher would and reads only its
tensors' shapes, dtypes, devices and strides, so a recorded call
computes what an unrecorded one computes.  It knows a tensor by a weak
reference (``WeakIdKeyDictionary``: the entry that produced it), never by
its address, and holds none alive.  Ops inside a kernel region are not
recorded (the region is one entry at its end); the region depth is per
thread, as the autograd engine runs a backward's ops, and its kernel
wrappers, on a thread of its own on the card.  One lock guards the
entries and the producer map against that thread.
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from ..kernels import _build
from .step_trace import ALLOC_OPS, Entry, TensorMeta, dtype_name


def meta_of(t: torch.Tensor) -> TensorMeta:
    return TensorMeta(tuple(int(d) for d in t.shape), dtype_name(t.dtype),
                      t.device.type, bool(t.is_contiguous()))


def _flat(v: Any, out: List[Any]) -> None:
    if isinstance(v, torch.Tensor):
        out.append(v)
    elif isinstance(v, (list, tuple)):
        for e in v:
            _flat(e, out)


def _simple(v: Any) -> bool:
    return v is None or isinstance(v, (bool, int, float, str, torch.dtype))


def _writes(func) -> bool:
    """Whether the op's schema writes one of its arguments."""
    return any(a.alias_info is not None and a.alias_info.is_write
               for a in func._schema.arguments)


class OpRecorder(TorchDispatchMode):
    """Records the ops dispatched while it is entered into
    :attr:`entries` (step_trace.py ``Entry``), and the kernel
    regions that end meanwhile."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # the recorder sees eager steps only (the port compiles none): no
        # need to wrap __torch_dispatch__ in torch._disable_dynamo, whose
        # first call imports dynamo (~2 s on the CPU rig, ~10 s on the
        # card's host)
        return False

    def __init__(self):
        super().__init__()
        self.entries: List[Entry] = []
        self._lock = threading.Lock()
        self._made = WeakIdKeyDictionary()
        self._main = threading.get_ident()

    def __enter__(self):
        if _build.region_sink is not None:
            raise RuntimeError("a recording is already running")
        _build.region_sink = self._region
        try:
            return super().__enter__()
        except BaseException:
            _build.region_sink = None
            raise

    def __exit__(self, *exc):
        _build.region_sink = None
        return super().__exit__(*exc)

    def _thread(self) -> str:
        if threading.get_ident() == self._main:
            return "main"
        return threading.current_thread().name

    def _srcs(self, ts) -> Tuple[Optional[Tuple[int, int]], ...]:
        return tuple(self._made.get(t) for t in ts)

    def _append(self, entry: Entry, ins, outs) -> None:
        with self._lock:
            entry.src = self._srcs(ins)
            i = len(self.entries)
            self.entries.append(entry)
            for k, t in enumerate(outs):
                if isinstance(t, torch.Tensor):
                    self._made[t] = (i, k)

    def _region(self, instance: str, inputs, out, launches: int) -> None:
        """A kernel region's end: one ``kernel:<instance>`` entry reading
        the region's inputs and writing its output (a tensor, or
        ``(shape, dtype, device)`` for an output the plain version does
        not build), made in ``launches`` launches."""
        ins: List[Any] = []
        _flat(inputs, ins)
        if isinstance(out, torch.Tensor):
            outs, om = [out], (meta_of(out),)
        elif out is not None:
            shape, dt, dev = out
            outs, om = [], (TensorMeta(tuple(shape), dtype_name(dt), dev),)
        else:
            outs, om = [], ()
        im = tuple(meta_of(t) for t in ins)
        self._append(Entry(
            op=f"kernel:{instance}", ins=im, outs=om,
            operands=tuple(("t", i) for i in range(len(ins))),
            read=sum(m.nbytes for m in im),
            write=sum(m.nbytes for m in om), launches=launches,
            thread=self._thread()),
            ins, outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if _build.in_region():
            return out
        ins: List[Any] = []
        operands = []
        for a in args:
            if isinstance(a, torch.Tensor):
                operands.append(("t", len(ins)))
                ins.append(a)
            elif isinstance(a, (bool, int, float)):
                operands.append(("n", a))
            else:
                _flat(a, ins)
                operands.append(("x", None))
        kw = {}
        for k, v in kwargs.items():
            if isinstance(v, torch.Tensor) or isinstance(v, (list, tuple)):
                _flat(v, ins)
            elif _simple(v):
                kw[k] = dtype_name(v) if isinstance(v, torch.dtype) else v
        outs: List[Any] = []
        _flat(out, outs)
        name = str(func.overloadpacket.__name__) + "." + \
            str(func._overloadname)
        view = bool(getattr(func, "is_view", False))
        inplace = _writes(func)
        im = tuple(meta_of(t) for t in ins)
        om = tuple(meta_of(t) for t in outs)
        if view:
            read = write = 0
        elif name in ALLOC_OPS:
            read, write = 0, 0
        elif inplace:
            read = sum(m.nbytes for m in im)
            write = im[0].nbytes if im else 0
        else:
            read = sum(m.nbytes for m in im)
            write = sum(m.nbytes for m in om)
        self._append(Entry(op=name, ins=im, outs=om,
                           operands=tuple(operands), kw=kw, read=read,
                           write=write, inplace=inplace, view=view,
                           thread=self._thread()), ins, outs)
        return out
