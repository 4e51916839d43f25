"""roc-lint for the port (``roc_tpu/analysis``): the host-side levels of
the JAX package's static analysis, over ``roc_tpu_torch/`` and
``chip_smoke.py``.  Every level is pure AST or a pure state machine and
imports no torch:

- :mod:`ast_lint` — source rules over the tree (stdout discipline, host
  syncs and host→device copies in hot paths, steps that bypass the
  first-step observer, kernels that fall back on a failed launch,
  swallowed exceptions, hand-stamped events, ad-hoc metrics, full fp32
  copies of quantized tables);
- :mod:`concurrency_lint` — the threading and signal surface (lock-order
  cycles, signal-handler safety, condvar predicates, unguarded shared
  state, blocking under locks, thread shutdown paths, multi-process
  checkpoint-rotation ownership);
- :mod:`protocol_lint` — the router↔replica wire vocabulary and the
  checkpoint commit sites held against :mod:`protocol_specs`, and
  :mod:`modelcheck`'s bounded exhaustive exploration of the request
  lifecycle, the checkpoint two-phase commit and the table swap.

The JAX package's trace levels (jaxprs, HLO, the program space,
collectives, sharding) read programs the port does not have.

:mod:`driver` runs the levels; ``python -m roc_tpu_torch.analysis`` is
the CLI, ratcheted by ``roc_tpu_torch/analysis/lint_baseline.json``.
"""

from .findings import Finding, load_baseline, save_baseline, split_findings

__all__ = ["Finding", "load_baseline", "save_baseline", "split_findings"]
