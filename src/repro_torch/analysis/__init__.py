"""Concurrency-correctness subsystem: static lint (``lint``) + runtime
lock-order witness (``lockwitness``), copies of ``repro/analysis``'s
modules of the same names.

``lockwitness`` is imported by ``repro_torch.core`` (lock construction
goes through it), so it must stay stdlib-only; ``lint`` is only pulled in
by the tests.
"""
from .lockwitness import (          # noqa: F401
    REGISTRY,
    LockOrderWitness,
    activate,
    active_witness,
    deactivate,
    named_lock,
    named_rlock,
    note_transport_call,
    scoped_witness,
)
