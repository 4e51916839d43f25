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
