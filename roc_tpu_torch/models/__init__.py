"""The model zoo.  :func:`model_builders` is the one name -> builder
registry (``roc_tpu/models/__init__.py``): the training CLI resolves
``--model`` through it."""

from __future__ import annotations

from typing import Callable, Dict


def model_builders() -> Dict[str, Callable]:
    from .appnp import build_appnp
    from .gat import build_gat
    from .gcn import build_gcn
    from .gcn2 import build_gcn2
    from .gin import build_gin
    from .sage import build_sage
    from .sgc import build_sgc
    return {"gcn": build_gcn, "sage": build_sage, "gin": build_gin,
            "gat": build_gat, "sgc": build_sgc, "appnp": build_appnp,
            "gcn2": build_gcn2}
