"""Where the port's layers report their work to a running tally.

The collective helpers (``parallel/sharding.py``) call
``record_collective`` with each collective's result, and each kernel's
wrapper (``kernels/*.py``) is decorated ``counts_as(plain)``. Both do
nothing until a counter is set (``set_sink``): ``launch/tally.py`` sets
one for the step it counts. This module imports nothing of the port, so
the layers below depend on it and not on the launcher above them.

A sink has two methods: ``collective(kind, result)``, and ``kernel(plain,
kernel, args, kwargs)``, which runs ``kernel(*args, **kwargs)``, counts
what ``plain`` would on the same arguments and returns the kernel's
result.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional

_SINK: Optional[Any] = None


def set_sink(sink: Optional[Any]) -> Optional[Any]:
    """Make ``sink`` the active counter (None: none); returns the one before."""
    global _SINK
    prev, _SINK = _SINK, sink
    return prev


def record_collective(kind: str, result) -> None:
    """Count one collective of ``kind`` whose result is the tensor
    ``result`` (the gathered or reduced array, an all-to-all's received
    buffer) in the active counter, if any."""
    if _SINK is not None:
        _SINK.collective(kind, result)


def counts_as(plain: Callable) -> Callable:
    """Decorate a kernel's wrapper, whose signature is its plain version
    ``plain``'s: under an active counter the call counts as ``plain`` on
    the same arguments would, and the wrapper's own ops do not count."""
    def wrap(kernel: Callable) -> Callable:
        @functools.wraps(kernel)
        def run(*args, **kwargs):
            if _SINK is None:
                return kernel(*args, **kwargs)
            return _SINK.kernel(plain, kernel, args, kwargs)
        return run
    return wrap
