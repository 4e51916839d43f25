"""Observability (``roc_tpu/obs``): the event bus (``events.py``), the
stall watchdog (``heartbeat.py``), the streaming metrics registry
(``metrics_registry.py``) and the SLO engine (``slo.py``).  The timeline
merger is not ported."""
