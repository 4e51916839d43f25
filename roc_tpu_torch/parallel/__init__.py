"""Multi-partition execution (``roc_tpu/parallel``): the partitioned
trainer over ``torch.distributed`` (``distributed.py``) and the ring halo
(``ring.py``).

Ported subset: one partition per rank on one host, the all-gather and
the ring halo, the cost-model split and online rebalancing.  The
multi-host loader (``multihost.py``) and the ``(parts, model)`` mesh are
not ported yet.
"""
