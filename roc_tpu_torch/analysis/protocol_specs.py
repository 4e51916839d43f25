"""Declared protocol spec tables (``roc_tpu/analysis/protocol_specs.py``)
— the protocol level's contract, naming the port's files.  The kinds and
fields of every channel are the JAX package's: the port speaks the same
wire.

These tables are the DECLARED protocol: the line-JSON wire vocabulary
the router and its replicas speak (per-kind field contracts included),
the request-lifecycle and checkpoint-commit transition sites, and the
invariants the bounded model checker (:mod:`modelcheck`) proves over
the three protocol models.  :mod:`protocol_lint` extracts the ACTUAL
protocol from the AST of the five protocol modules and cross-validates
it against these tables — any disagreement is a ``protocol-spec-drift``
finding, in either direction:

- code sends/handles a kind (or field, or transition site) this file
  does not declare → the change must extend the spec table FIRST;
- this file declares something the code no longer has → the table is
  stale and must shrink.

That makes the spec the extension point for the rollout/autoscaler/
resize changes: add the new kind's row here, watch the lint tell you every
send/handle/field site the implementation still owes.

This module imports no torch and is near-declarative: besides the tables it
carries only the tiny AST helper both the protocol and concurrency
levels use to inventory checkpoint-v3 artifact writers (ONE source of
truth for the callee-name sets).
"""

from __future__ import annotations

import ast
from typing import Any, Dict, List

# ------------------------------------------------------- wire protocol
#
# One entry per directed channel.  Per kind:
#   required  fields every send site of this kind MUST carry
#   optional  fields a send site MAY carry (variant shapes — e.g. the
#             ok/error halves of ``res``)
#   sent      False for kinds the in-tree sender legitimately never
#             puts on the wire (with ``note`` saying why); the
#             wire-vocabulary rule would otherwise flag the receiver
#             branch as dead vocabulary
WIRE_CHANNELS: List[Dict[str, Any]] = [
    {
        "name": "router->replica",
        "sender": "roc_tpu_torch/serve/router.py",
        "receiver": "roc_tpu_torch/serve/replica.py",
        "kinds": {
            "req": {
                "required": ("kind", "id", "ids", "deadline_ms",
                             "rid"),
                "optional": (),
                "sent": True,
            },
            "close": {
                "required": ("kind",),
                "optional": (),
                # Router.close() closes the replica's stdin instead of
                # writing this line: stdin EOF and {"kind": "close"}
                # funnel into the same drain path, and EOF also covers
                # a router that died without draining
                "sent": False,
                "note": "stdin EOF is the close signal "
                        "(Router.close closes the pipe)",
            },
            # sharded-table gather leg, declared HERE first
            # per the spec-first workflow: a replica serving a table
            # SLICE fetches rows it does not own from the owning
            # replica, via the router.  The router forwards the
            # requester's fetch_rows to the owner and relays the
            # owner's rows answer back — both kinds therefore exist on
            # BOTH channels.  "version" is the requester's captured
            # TableVersion: the gather is version-PINNED (the owner
            # refuses to answer from a different table version, so a
            # mid-rollout gather can never mix versions — the
            # gather-version-pinned model invariant below).
            "fetch_rows": {
                "required": ("kind", "gid", "ids", "version"),
                "optional": (),
                "sent": True,
            },
            "rows": {
                # ok answers carry the owned rows (raw stored values:
                # fp32 rows, or int8/fp8 codes + per-row scales — the
                # requester stages them verbatim, bit-exact); refusals
                # (version mismatch, un-owned ids) carry "error" with
                # rows empty
                "required": ("kind", "gid", "ids", "rows", "version",
                             "qmode"),
                "optional": ("scales", "replica", "error"),
                "sent": True,
            },
        },
    },
    {
        "name": "replica->router",
        "sender": "roc_tpu_torch/serve/replica.py",
        "receiver": "roc_tpu_torch/serve/router.py",
        "kinds": {
            # the gather leg's other half: the REQUESTER
            # replica originates fetch_rows (router forwards it to the
            # owner), and the OWNER replica answers with rows (router
            # relays it back by gid) — same field contracts as the
            # router->replica declarations above, because the router
            # is a pure forwarder that re-builds the line verbatim
            "fetch_rows": {
                "required": ("kind", "gid", "ids", "version"),
                "optional": (),
                "sent": True,
            },
            "rows": {
                "required": ("kind", "gid", "ids", "rows", "version",
                             "qmode"),
                "optional": ("scales", "replica", "error"),
                "sent": True,
            },
            "ready": {
                # "quant": the replica advertises its serving
                # tables' quantization mode (off/int8/fp8) so the
                # router's fleet view can refuse a mixed-mode rollout
                # it did not ask for — declared HERE first, per the
                # spec-first workflow: the wire-field-contract rule
                # then reports every send site still owed the field
                # "table_version": the published TableVersion
                # the replica cold-loaded — the router's fleet view of
                # version skew, and the epoch gathers pin against;
                # "table_bytes" rides along so the capacity scenario
                # can assert the per-replica byte budget from the
                # fleet view (sliced loads advertise O(V/N) bytes)
                "required": ("kind", "replica", "pid", "num_nodes",
                             "num_classes", "buckets", "backend",
                             "shard", "quant", "table_version"),
                "optional": ("table_bytes",),
                "sent": True,
            },
            "hb": {
                "required": ("kind", "inflight", "served", "mono"),
                "optional": (),
                "sent": True,
            },
            "res": {
                "required": ("kind", "id", "ok"),
                # ok=true carries rows+version (+qmode: the
                # quant spec of the table VERSION the microbatch was
                # pinned to — a mid-rollout fp32→int8 swap answers
                # with the captured version's mode, and the wire says
                # so); ok=false carries the typed error triple — both
                # shapes are ``res``.  It also carries the answering
                # replica's owned shard range ("shard") and the
                # microbatch's cross-shard gather wall ("gather_ms",
                # None when every id was owned) — the request-path
                # evidence behind the serve_gather_p50_ms column
                "optional": ("rows", "version", "qmode", "error",
                             "msg", "retryable", "shard", "gather_ms"),
                "sent": True,
            },
            "drained": {
                "required": ("kind", "clean", "replica", "served"),
                "optional": (),
                "sent": True,
            },
        },
    },
]

# -------------------------------------------------- transition sites
#
# The request-lifecycle and checkpoint-commit state machines, named by
# the functions that implement their transitions.  Extraction verifies
# each declared site still exists (a rename/removal without a spec
# edit is drift) and the surface reports each site's line — the
# machine-readable "where does this protocol live" index.
LIFECYCLE_SITES: Dict[str, tuple] = {
    # router request lifecycle: admit → dispatch → result/failover/
    # hedge → complete/fail, with the monitor as the deadline backstop
    "roc_tpu_torch/serve/router.py": (
        "Router.submit", "Router._dispatch", "Router._on_result",
        "Router._complete", "Router._fail_sub", "Router._mark_dead",
        "Router._monitor_loop", "Router.close",
    ),
    # replica side: the stdin→drain lifecycle
    "roc_tpu_torch/serve/replica.py": ("serve_loop",),
    # in-process server: admission + the versioned-table microbatch
    "roc_tpu_torch/serve/server.py": (
        "Server.submit", "Server._dispatch", "Server.drain",
        "Server.close",
    ),
}

COMMIT_SITES: Dict[str, tuple] = {
    # checkpoint-v3 two-phase commit: shard writes → renames →
    # manifest publish (the commit record), and the restore-side
    # validators that refuse torn state
    "roc_tpu_torch/utils/checkpoint.py": (
        "write_snapshot", "_write_shard", "commit_manifest",
        "read_manifest", "is_committed",
    ),
    # the async saver drives write_snapshot off the step path;
    # submit/flush are where a stored error re-raises
    "roc_tpu_torch/resilience/async_save.py": (
        "AsyncSaver.submit", "AsyncSaver.flush", "AsyncSaver._process",
    ),
}

# ---------------------------------------------------- model invariants
#
# Declared per-model invariant tables, cross-checked against
# modelcheck.model_invariants() — a model gaining/losing an invariant
# without a spec edit is drift.
MODEL_INVARIANTS: Dict[str, tuple] = {
    "router-lifecycle": (
        "terminal-exactly-once",
        "failover-requeue-at-most-once",
        "no-completion-after-close",
        "deadline-liveness",
    ),
    "ckpt-commit": (
        "manifest-published-last",
        "restore-never-torn",
    ),
    "table-swap": (
        "single-version-batch",
        # Every published version carries its quant spec, and a
        # row must be DECODED with the qmode of the version it was
        # read from — serving an fp32-captured batch through the int8
        # dequant program (or vice versa, mid-rollout) is garbage even
        # when the version ids agree.  Seedable as "live-qmode".
        "quant-spec-pinned",
        # A sharded replica's cross-shard gather must return
        # rows from exactly the version the microbatch captured — a
        # gather answered from the owner's LIVE published version
        # mid-rollout would mix two table versions inside one batch
        # even though every locally-served row is pinned.  Seedable as
        # "shard-gather".
        "gather-version-pinned",
    ),
}

# -------------------------------------- checkpoint artifact inventory
#
# Checkpoint-v3 writer vocabulary (utils/checkpoint.py): the manifest
# publish is the COMMIT RECORD and must follow every shard rename.
# These sets are the ONE source of truth — the protocol level's
# ckpt-commit-order rule and the concurrency level's artifact surface
# both read them.
MANIFEST_COMMITTERS = frozenset({"commit_manifest"})
SHARD_WRITERS = frozenset({"write_snapshot", "_write_shard"})


def walk_tree(tree: ast.AST) -> List[ast.AST]:
    """``list(ast.walk(tree))``, kept on the tree: the levels walk each
    module many times over."""
    memo = getattr(tree, "_roc_walk", None)
    if memo is None:
        memo = tree._roc_walk = list(ast.walk(tree))
    return memo


def ckpt_artifact_entries(tree: ast.Module) -> List[Dict[str, Any]]:
    """Checkpoint-v3 artifact inventory for ONE module's AST:
    ``ckpt-shard`` entries for shard-writer call sites (per-process
    ``shard_<proc>.npz`` filenames ARE the ownership evidence) and
    ``ckpt-manifest`` entries for manifest commits (proc-0, after
    every shard rename).  Shared by the protocol surface and the
    concurrency level's artifact surface."""
    out: List[Dict[str, Any]] = []
    for node in walk_tree(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        callee = (f.id if isinstance(f, ast.Name)
                  else f.attr if isinstance(f, ast.Attribute)
                  else None)
        if callee in SHARD_WRITERS:
            out.append({"kind": "ckpt-shard", "line": node.lineno,
                        "owner": "per-process-file"})
        elif callee in MANIFEST_COMMITTERS:
            out.append({"kind": "ckpt-manifest", "line": node.lineno,
                        "owner": "proc0-commit-after-shards"})
    return out
