"""The runtime lock-order witness (``lockwitness``), a copy of
``repro/analysis/lockwitness.py``: the copied control plane builds its
locks through it. The static lint stays in the JAX package."""
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
