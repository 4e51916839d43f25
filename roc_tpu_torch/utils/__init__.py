"""Utilities (``roc_tpu/utils``): the checkpoint format (``checkpoint.py``)
and the profiler trace, the epoch timer and the metrics log
(``profiling.py``)."""
