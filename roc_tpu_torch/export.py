"""``python -m roc_tpu_torch.export``: the serve export CLI (the
implementation is roc_tpu_torch/serve/export.py)."""

import sys

from .serve.export import main

if __name__ == "__main__":
    sys.exit(main())
