"""Observability (``roc_tpu/obs``): the ported subset is the event bus
(``events.py``) and the stall watchdog (``heartbeat.py``), which the
checkpoint and recovery path emit through.  The metrics registry, the
timeline merger and the SLO engine are not ported."""
