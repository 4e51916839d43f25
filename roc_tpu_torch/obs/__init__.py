"""Observability (``roc_tpu/obs``): the event bus (``events.py``), the
stall watchdog (``heartbeat.py``), the streaming metrics registry
(``metrics_registry.py``), the SLO engine (``slo.py``), the run manifest
(``manifest.py``, :func:`run_manifest`), the first-step observer
(``compile_watch.py``) and the timeline merger (``timeline.py``, stdlib
only; ``python -m roc_tpu_torch.timeline``).  Not ported yet: the
sentinel over bench rounds (``sentinel.py``) and the compile cache."""

from .manifest import run_manifest

__all__ = ["run_manifest"]
