"""Back-compat shim (``roc_tpu/utils/resilience.py``): the recovery
machinery lives in :mod:`roc_tpu_torch.resilience` (the rotation and the
retry loop in ``resilience/recovery.py``, preemption in
``resilience/preempt.py``, fault injection in ``resilience/inject.py``).
This module re-exports the JAX package's names from there."""

from __future__ import annotations

from ..obs.heartbeat import StallFailure  # noqa: F401
from ..resilience.preempt import Preempted, RESTARTABLE_EXIT_CODE  # noqa: F401
from ..resilience.recovery import (  # noqa: F401
    RECOVERABLE, CheckpointRotation, NumericFailure, check_finite,
    check_params_finite, train_with_recovery)
