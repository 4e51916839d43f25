"""``python -m roc_tpu_torch.sentinel`` — the performance-regression gate
over the port's bench rounds and a live run's metrics JSONL
(``roc_tpu/sentinel.py``).

A thin entry point over :mod:`roc_tpu_torch.obs.sentinel`, which is
stdlib only and also runs as a plain script without torch:
``python roc_tpu_torch/obs/sentinel.py ...``.  Exits 1 on a regression
beyond noise, 2 on an unreadable metrics file; ``--json`` prints one
machine-readable line.
"""

from __future__ import annotations

import sys

from .obs.sentinel import (bench_history, bench_verdict,  # noqa: F401
                           check_run, detect, main, metrics_summary)

if __name__ == "__main__":
    sys.exit(main())
