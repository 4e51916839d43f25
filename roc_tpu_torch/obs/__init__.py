"""Observability (``roc_tpu/obs``): the event bus (``events.py``), the
stall watchdog (``heartbeat.py``), the streaming metrics registry
(``metrics_registry.py``), the SLO engine (``slo.py``), the run manifest
(``manifest.py``, :func:`run_manifest`), the first-step observer
(``compile_watch.py``), the timeline merger (``timeline.py``; ``python
-m roc_tpu_torch.timeline``) and the regression sentinel over the port's
bench rounds and a run's metrics (``sentinel.py``; ``python -m
roc_tpu_torch.sentinel``), the last two stdlib only.  The kernels' build
cache is ``utils/compile_cache.py``."""

from .manifest import run_manifest

__all__ = ["run_manifest"]
