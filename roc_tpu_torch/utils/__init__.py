"""Utilities (``roc_tpu/utils``): the checkpoint format (``checkpoint.py``)."""
