"""Run manifest (``roc_tpu/obs/manifest.py``): the event that makes a run
self-describing.

Emitted once at trainer setup (both trainers), up front in the event
stream: what code (git sha, torch and CUDA versions), what hardware (the
card's name, or the CPU), what data (V/E/name), and what the trainer
decided (the resolved ``aggr_impl``/``aggr_fuse``/halo/features/remat).
The stderr echoes stay, but the manifest is the record a post-mortem can
trust to describe the run that executed, not the flags that were asked
for.  Its keys are the JAX package's, with ``torch_version`` and
``cuda_version`` where that has ``jax_version``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

from .events import _jsonable, emit, set_clock_identity

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))


def git_sha(repo_root: str = _REPO_ROOT) -> Optional[str]:
    """HEAD commit sha without shelling out (works where git itself is
    absent); None when not a git checkout."""
    try:
        head_path = os.path.join(repo_root, ".git", "HEAD")
        with open(head_path) as f:
            head = f.read().strip()
        if head.startswith("ref:"):
            ref = head.split(None, 1)[1]
            ref_path = os.path.join(repo_root, ".git", *ref.split("/"))
            if os.path.exists(ref_path):
                with open(ref_path) as f:
                    return f.read().strip()
            packed = os.path.join(repo_root, ".git", "packed-refs")
            with open(packed) as f:
                for line in f:
                    if line.strip().endswith(ref):
                        return line.split()[0]
            return None
        return head
    except OSError:
        return None


def dtype_name(d: Any) -> Any:
    """A torch dtype by its name ('float32', 'bfloat16'), the strings the
    JAX manifest writes; anything else as it is."""
    s = str(d)
    return s[len("torch."):] if s.startswith("torch.") else d


def _config_dict(config) -> Dict[str, Any]:
    d = {f.name: getattr(config, f.name)
         for f in dataclasses.fields(config)}
    for k in ("dtype", "compute_dtype"):
        if d.get(k) is not None:
            d[k] = dtype_name(d[k])
    return _jsonable(d)


def _devices(device) -> Dict[str, Any]:
    """platform, device_count, device_kinds of the run's ``device`` (None:
    the card when one is present, else the CPU)."""
    import torch
    dev = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        return {"device_count": n, "platform": "gpu",
                "device_kinds": sorted({torch.cuda.get_device_name(i)
                                        for i in range(n)})}
    return {"device_count": 1, "platform": "cpu", "device_kinds": ["cpu"]}


def run_manifest(config=None, dataset=None, model=None,
                 num_parts: int = 1,
                 extra: Optional[Dict[str, Any]] = None,
                 console: bool = True, device=None) -> Dict[str, Any]:
    """Assemble and emit the ``manifest`` event; returns the fields.
    ``device``: where the run executes (None: the card when one is
    present, else the CPU).  Pins the event bus's ``proc`` to this
    process's ``torch.distributed`` rank (0 without a process group), as
    the JAX manifest pins ``jax.process_index()``.

    Everything is best-effort: a missing backend or a detached checkout
    degrades to nulls, never to an exception at trainer setup."""
    fields: Dict[str, Any] = {"git_sha": git_sha()}
    try:
        import torch
        import torch.distributed as dist
        fields["torch_version"] = torch.__version__
        fields["cuda_version"] = torch.version.cuda
        up = dist.is_available() and dist.is_initialized()
        fields["process_index"] = dist.get_rank() if up else 0
        fields["process_count"] = dist.get_world_size() if up else 1
        set_clock_identity(proc=fields["process_index"])
        fields.update(_devices(device))
    except Exception as e:  # noqa: BLE001 - backendless manifest
        fields["backend_error"] = repr(e)
    if config is not None:
        fields["config"] = _config_dict(config)
        fields["resolved"] = {
            "aggr_impl": getattr(config, "aggr_impl", None),
            "aggr_fuse": getattr(config, "aggr_fuse", None),
            "halo": getattr(config, "halo", None),
            "features": getattr(config, "features", None),
            "remat": getattr(config, "remat", None),
            "num_parts": num_parts,
        }
    if dataset is not None:
        g = dataset.graph
        fields["dataset"] = {"name": dataset.name,
                             "num_nodes": int(g.num_nodes),
                             "num_edges": int(g.num_edges),
                             "num_classes": int(dataset.num_classes)}
    if model is not None:
        try:
            fields["model"] = {
                "ops": [op.kind for op in model._ops],
                "fused_aggregates": model.num_fused_aggregates(),
            }
        except Exception:  # noqa: BLE001 - the op list may change shape
            pass
    if extra:
        fields.update(_jsonable(extra))
    msg = (f"run manifest: platform={fields.get('platform')} "
           f"devices={fields.get('device_count')} "
           f"torch={fields.get('torch_version')} "
           f"cuda={fields.get('cuda_version')} "
           f"sha={(fields.get('git_sha') or 'none')[:12]}")
    emit("manifest", msg, console=console, **fields)
    return fields
