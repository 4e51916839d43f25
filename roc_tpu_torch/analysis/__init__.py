"""roc-lint for the port (``roc_tpu/analysis``): the JAX package's static
analysis over ``roc_tpu_torch/`` and ``chip_smoke.py``.  The host-side
levels are pure AST or a pure state machine and import no torch:

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

The trace levels (analysis/driver.py) build the port on the CPU rig and
import torch lazily: the program space (:mod:`programspace`), the
collectives (:mod:`collective_lint`), the recorded steps' jaxpr and HLO
rules (:mod:`step_trace` records a step's aten ops, each kernel one
opaque entry, in the jaxpr's place; :mod:`jaxpr_lint`, :mod:`hlo_lint`)
and the sharding audit (:mod:`sharding_lint`: the replication ledger,
its budget and the live 2x2 mesh).

:mod:`driver` runs the levels; ``python -m roc_tpu_torch.analysis`` is
the CLI, ratcheted by ``roc_tpu_torch/analysis/lint_baseline.json``.
"""

from .findings import Finding, load_baseline, save_baseline, split_findings

__all__ = ["Finding", "load_baseline", "save_baseline", "split_findings"]
