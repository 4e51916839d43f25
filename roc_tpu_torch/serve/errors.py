"""Typed serving failures: the only ways a request is allowed to fail
(``roc_tpu/serve/errors.py``).  An accepted request either completes with
a correct answer or fails with one of these types, never a hang.
"""

from __future__ import annotations


class ServeError(RuntimeError):
    """Base class for every typed serving failure."""


class ServeTimeout(ServeError):
    """The request's ``deadline_ms`` expired before a dispatch could
    complete it (delivered at a microbatch boundary)."""


class ServeOverload(ServeError):
    """Load shed: the bounded admission queue was full at submit time."""


class ServeClosed(ServeError):
    """The server is closed or draining: late ``submit()`` calls are
    rejected with this."""


class GatherError(ServeError):
    """The cross-shard gather leg failed: a sliced replica could not
    fetch rows it does not own at the microbatch's captured table
    version (owner refused the version pin twice, owner died
    mid-fetch, no gather path configured, or the microbatch's foreign
    set exceeded the staging halo).  Retryable at the router level —
    a re-dispatch captures a fresh version and gathers again."""


class ReplicaLost(ServeError):
    """Router-internal: the replica holding this request died.  Client
    code normally never sees it — the router requeues the request onto
    a surviving replica; it surfaces only when NO replica can serve
    the request's shard anymore."""
