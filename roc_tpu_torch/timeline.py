"""``python -m roc_tpu_torch.timeline`` — merge N per-process event and
metrics JSONL streams into one Perfetto-loadable Chrome-trace JSON
(``roc_tpu/timeline.py``).

A thin entry point over :mod:`roc_tpu_torch.obs.timeline`, which is
stdlib only and also runs as a plain script without torch:
``python roc_tpu_torch/obs/timeline.py ...`` (``-m`` imports the
``roc_tpu_torch`` package, and so torch, on the way in).
"""

from __future__ import annotations

import sys

from .obs.timeline import (clock_offsets, expand_paths,  # noqa: F401
                           main, merge_timeline, request_trace,
                           straggler_records)

if __name__ == "__main__":
    sys.exit(main())
