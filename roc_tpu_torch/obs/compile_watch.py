"""First-step observer (the part of ``roc_tpu/obs/compile_watch.py`` that
has a meaning without XLA): what the first step of a step slot did,
against what was modeled.

There is no compile here: a slot's first call is its first step (cold
kernels, the allocator's first blocks, library handles).
:class:`ObservedStep` runs that call under
``torch.utils.flop_counter.FlopCounterMode`` and emits one ``compile``
event (the JAX package's category) with:

- ``first_step_s``, the call's wall time, synchronised (the JAX event's
  ``lower_s``/``compile_s``);
- ``flops``: the aten ops' count (``flops_counted``: the matmuls, the
  backward's under ``torch.autograd.grad`` too) plus the hand-written
  kernels' (``flops_kernels``): ``FlopCounterMode`` cannot see a
  ``ctypes`` launch, so each kernel wrapper adds its arithmetic to a
  per-process tally (kernels/_build.py ``kernel_ops``,
  ``ops_launched``), read around the call;
- ``peak_bytes``: the CUDA allocator's peak since the caller's last
  ``reset_peak_memory_stats``, read after the call (never reset here);
  None on the CPU.  ``bytes_accessed`` is null: nothing measures it;
- ``modeled_bytes`` (core/memory.py's estimate, the trainer's
  ``modeled_bytes``), ``model_delta_bytes`` and ``model_actual_ratio``,
  with the JAX package's warning when the model undershoots the peak.

After its first call the observer adds nothing to the step.  Only the
observation may degrade: a counter or a read that fails, or a FLOP
formula that fails on an op (the op's output is returned all the same,
:func:`_counter`), drops the observation (``degraded=True``) and the
step runs as it would; the step's own errors propagate.
:func:`peak_flops_per_s` is the MFU denominator.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

from .events import emit

# Peak dense FLOP/s per card, keyed by a substring of
# torch.cuda.get_device_name: one bf16 tensor-core figure a card, the
# JAX package's convention (a coarse, stable MFU denominator, not a
# ceiling for every dtype).  NVIDIA H100 SXM: 989 TFLOP/s dense bf16.
# The CPU, and any card without a row, gives None: the mfu field is then
# left out rather than fabricated.
PEAK_FLOPS_BY_KIND = {
    "h100": 989e12,
}


def peak_flops_per_s(device_kind: Optional[str] = None
                     ) -> Optional[float]:
    """Peak FLOP/s for ``device_kind`` (default: card 0's name when a card
    is present); None when unknown."""
    if device_kind is None:
        try:
            import torch
            if not torch.cuda.is_available():
                return None
            device_kind = torch.cuda.get_device_name(0)
        except Exception:  # noqa: BLE001 - no card, no MFU
            return None
    kind = (device_kind or "").lower()
    for key, val in PEAK_FLOPS_BY_KIND.items():
        if key in kind:
            return val
    return None


def _bmm_flop(a_shape, b_shape, *_, out_shape=None, **kwargs) -> int:
    """2·B·M·N·K of ``bmm`` and of its ``out_dtype`` overload, whose
    dtype comes as a third positional argument that torch's own formula
    takes for its ``out_shape`` (the block-dense tiles' products run it
    on the card, ops/blockdense.py)."""
    b, m, k = a_shape
    return 2 * b * m * b_shape[2] * k


def _counter():
    """A ``FlopCounterMode`` whose count of one op may fail without
    failing the op: the op's output is returned and the first failure
    kept in ``error`` (the observation then degrades)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    class Counter(FlopCounterMode):
        error: Optional[BaseException] = None

        def _count_flops(self, func_packet, out, args, kwargs):
            try:
                return super()._count_flops(func_packet, out, args, kwargs)
            except Exception as e:  # noqa: BLE001 - the count, not the op
                if self.error is None:
                    self.error = e
                return out
    return Counter(display=False,
                   custom_mapping={torch.ops.aten.bmm: _bmm_flop})


_warmed = False


def _warm_counter() -> None:
    """Run the counter's first use in this process once, on a thread of
    its own: it imports much of torch (~2 s), and some of those imports
    leave reference cycles through the frames they ran in; run inside a
    trainer's step, such a cycle holds the trainer (its device memory)
    until the collector runs."""
    global _warmed
    if _warmed:
        return
    import threading
    import torch

    def first_use():
        with _counter():
            torch.ones(2, 2) @ torch.ones(2, 2)
    t = threading.Thread(target=first_use, name="flop-counter-warm")
    t.start()
    t.join()
    _warmed = True


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "?"
    if n >= 1 << 28:
        return f"{n / 1024**3:.2f}GiB"
    if n >= 1 << 17:
        return f"{n / 1024**2:.1f}MiB"
    return f"{n / 1024:.1f}KiB"


class ObservedStep:
    """A trainer step slot (``train_step``, ``eval_step``) with
    first-step telemetry: calls ``fn`` and, on the first call only,
    counts and times it (module docstring); the event's fields stay in
    :attr:`cost`.  ``device``: the step's device (its allocator's peak
    and its barrier).  ``modeled_bytes``: the memory plan's estimate for
    the step; when the measured peak exceeds it past both gates the
    event warns unconditionally."""

    # both gates must trip: the ratio (the model missed a term, not a
    # rounding) and an absolute floor (at toy scale fixed overheads
    # dominate any estimate): the JAX package's values
    UNDERSHOOT_WARN_RATIO = 1.1
    UNDERSHOOT_WARN_MIN_BYTES = 256 << 20

    def __init__(self, fn: Callable, *, name: str, device=None,
                 modeled_bytes: Optional[int] = None,
                 verbose: bool = False):
        import torch
        self.fn = fn
        self.name = name
        self.device = torch.device(device) if device is not None else None
        self.modeled_bytes = modeled_bytes
        self.verbose = verbose
        self.cost: Optional[Dict[str, Any]] = None   # the event's fields
        self._observed = False

    def __call__(self, *args, **kwargs):
        if self._observed:
            return self.fn(*args, **kwargs)
        self._observed = True
        try:
            from ..kernels import _build
            _warm_counter()
            counter = _counter()
            self._sync()
            ops0 = _build.ops_launched()
            t0 = time.perf_counter()
            counter.__enter__()
        except Exception as e:  # noqa: BLE001 - degrade, not die
            self._degrade(e)
            return self.fn(*args, **kwargs)
        # the step itself: its failures are its own and propagate
        try:
            out = self.fn(*args, **kwargs)
        finally:
            counter.__exit__(None, None, None)
        try:
            self._sync()
            first_s = time.perf_counter() - t0
            if counter.error is not None:
                raise counter.error
            self._emit(first_s, counter.get_total_flops(),
                       _build.ops_launched() - ops0)
        except Exception as e:  # noqa: BLE001 - degrade, not die
            self._degrade(e)
        return out

    def _is_cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def _sync(self) -> None:
        if self._is_cuda():
            import torch
            torch.cuda.synchronize(self.device)

    def _emit(self, first_s: float, counted: int, kernels: int) -> None:
        peak = None
        if self._is_cuda():
            import torch
            peak = int(torch.cuda.max_memory_allocated(self.device))
        fields: Dict[str, Any] = {
            "name": self.name,
            "first_step_s": round(first_s, 4),
            "flops": float(counted + kernels),
            "flops_counted": float(counted),
            "flops_kernels": float(kernels),
            "bytes_accessed": None,
            "peak_bytes": peak,
            "modeled_bytes": self.modeled_bytes,
        }
        undershoot = False
        if peak is not None and self.modeled_bytes:
            fields["model_delta_bytes"] = int(peak - self.modeled_bytes)
            fields["model_actual_ratio"] = round(
                peak / self.modeled_bytes, 3)
            undershoot = (
                peak > self.modeled_bytes * self.UNDERSHOOT_WARN_RATIO
                and peak - self.modeled_bytes
                > self.UNDERSHOOT_WARN_MIN_BYTES)
        emit("compile",
             f"first step {self.name}: {fields['first_step_s']}s, "
             f"flops={fields['flops']:.3g} (kernels "
             f"{fields['flops_kernels']:.3g}) peak={_fmt_bytes(peak)} "
             f"(modeled {_fmt_bytes(self.modeled_bytes)})",
             console=self.verbose, **fields)
        if undershoot:
            emit("compile",
                 f"memory plan undershoots the measured peak for "
                 f"{self.name}: modeled {_fmt_bytes(self.modeled_bytes)} "
                 f"< actual {_fmt_bytes(peak)} "
                 f"({fields['model_actual_ratio']:.2f}x) — the "
                 f"autopilot's budget accounting is missing a term",
                 warning=True, name=self.name)
        self.cost = fields

    def _degrade(self, e: BaseException) -> None:
        emit("compile",
             f"first-step observer disabled for {self.name}: "
             f"{type(e).__name__}: {e}",
             console=self.verbose, name=self.name, degraded=True)
