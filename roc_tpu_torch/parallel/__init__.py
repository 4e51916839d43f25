"""Multi-partition execution (``roc_tpu/parallel``): the partitioned
trainer over ``torch.distributed`` (``distributed.py``).

Ported subset: one partition per rank, the all-gather halo
(``halo='gather'``).  The ring halo (``ring.py``), the multi-host loader
(``multihost.py``) and the ``(parts, model)`` mesh are not ported yet.
"""
