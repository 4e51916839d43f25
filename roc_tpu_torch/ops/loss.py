"""Masked softmax cross-entropy and the training metrics
(``roc_tpu/ops/loss.py``, the reference's ``softmax_kernel.cu``).

- The objective is the *sum* (not the mean) of the cross-entropies over
  MASK_TRAIN rows; its gradient is ``softmax - onehot`` on train rows and
  0 elsewhere (``softmax_kernel.cu:19-33``).
- The printed "train loss" is not the cross-entropy: it is ``sum over
  train rows of (1 - p_true)`` (``softmax_kernel.cu:65``), reported with
  masked argmax accuracies for train/val/test.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..core.graph import MASK_TEST, MASK_TRAIN, MASK_VAL


def masked_softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    """Sum of CE over MASK_TRAIN rows, reduced in fp32.

    logits: [V, C] float; labels: [V] int32; mask: [V] int32 MASK_*."""
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = logp.gather(1, labels.long()[:, None])[:, 0]
    train = (mask == MASK_TRAIN).to(torch.float32)
    return -(ll * train).sum()


def perf_metrics(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The reference's ``PerfMetrics`` (``softmax_kernel.cu:35-39``) as
    unreduced 0-d sums on the logits' device."""
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    p_true = p.gather(1, labels.long()[:, None])[:, 0]
    correct = (logits.argmax(dim=-1) == labels.long()).to(torch.float32)
    out: Dict[str, torch.Tensor] = {}
    for name, mval in (("train", MASK_TRAIN), ("val", MASK_VAL),
                       ("test", MASK_TEST)):
        sel = (mask == mval).to(torch.float32)
        out[f"{name}_cnt"] = sel.sum()
        out[f"{name}_correct"] = (correct * sel).sum()
    train_sel = (mask == MASK_TRAIN).to(torch.float32)
    out["train_loss_sum"] = ((1.0 - p_true) * train_sel).sum()
    return out


def summarize_metrics(m: Dict[str, object]) -> Dict[str, float]:
    """Metric sums -> the printed quantities (``softmax_kernel.cu:141-
    152``).  Takes tensors (fetched together, one device sync), numpy
    values or floats."""
    if any(isinstance(v, torch.Tensor) for v in m.values()):
        keys = list(m)
        vals = torch.stack([torch.as_tensor(m[k], dtype=torch.float32)
                            for k in keys]).cpu().tolist()
        m = dict(zip(keys, vals))

    def _div(a, b):
        return float(a) / max(float(b), 1.0)
    return {
        # the reference prints the raw sum, not a mean
        "train_loss": float(m["train_loss_sum"]),
        "train_acc": _div(m["train_correct"], m["train_cnt"]),
        "val_acc": _div(m["val_correct"], m["val_cnt"]),
        "test_acc": _div(m["test_correct"], m["test_cnt"]),
        "train_cnt": int(m["train_cnt"]),
        "val_cnt": int(m["val_cnt"]),
        "test_cnt": int(m["test_cnt"]),
        "train_correct": int(m["train_correct"]),
        "val_correct": int(m["val_correct"]),
        "test_correct": int(m["test_correct"]),
    }
