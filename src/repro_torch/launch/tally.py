"""The work of one step, counted as it runs: the port's counterpart of
``repro/launch/hloparse.py``.

JAX's dry-run compiles a step and parses the partitioned HLO for its
collectives, its ``dot`` FLOPs and its result bytes. The port has no HLO:
it runs the step (eagerly, on one rank) inside ``tally()``, which counts
the same quantities as they happen and keeps ``Tally``'s field names. The
layers report to it through ``tally_hooks``, which ``tally()`` points at
its counter:

* ``dot_flops``: every aten product (mm, bmm, addmm, baddbmm,
  convolutions and PyTorch's attention), by the formulas of
  ``torch.utils.flop_counter``, plus each kernel's products, which its
  wrapper in ``kernels/*.py`` reports (``tally_hooks.counts_as``) as what
  its plain version's einsums count: the plain version run on meta
  tensors under a counter of its own, so attention counts full sq x skv
  scores, as JAX's einsum attention does. On the CPU the plain version
  itself runs and its einsums are counted as aten products, so a step's
  tally is the same on the card and on the CPU (its result bytes likewise:
  a wrapper adds its plain version's, and its own ops are not counted).
* ``collective_bytes`` and ``collective_counts`` by HLO kind
  (``COLLECTIVES``), each collective's bytes the size of its result, as
  ``shape_bytes`` counts an HLO result. They are counted where the port
  issues them (``tally_hooks.record_collective``: the helpers of
  ``parallel/sharding.py`` and their callers in ``models/moe.py``,
  ``optim/adamw.py``, ``parallel/compress.py`` and ``runtime/elastic.py``);
  the sequence split's halo, which JAX lowers to a collective-permute, is
  counted as one. Split by the result's rank as ``analyze`` splits them:
  rank <= 2 all-gathers (the weights' gathers), other rank <= 2 results
  (the gradients' reductions), rank >= 3 (activations).
* ``result_bytes``: the bytes of every aten op's outputs, views excluded
  (the memory-traffic proxy of ``analyze``). A copy that only lays out
  values already counted (``clone``: the copy ``contiguous`` or a reshape
  makes) is not counted, nor ``_unsafe_view``, a view: a kernel and its
  plain version lay out their outputs differently, and the copies that
  follow would otherwise differ between the card and the CPU.

``analyze``'s ``trip_counts`` has no counterpart: HLO runs a ``while``
body once per trip and the parser must weigh it, while eager code runs
every trip and each is counted as it runs.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
from torch.utils._pytree import tree_flatten

from .. import tally_hooks

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclass
class Tally:
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    # by result rank: <= 2 -> parameter tensors (FSDP gathers / gradient
    # reductions), >= 3 -> activations (hloparse.Tally's buckets)
    collective_bytes_ag2d: float = 0.0     # weight all-gathers
    collective_bytes_other2d: float = 0.0  # gradient all-reduces etc.
    collective_bytes_hi: float = 0.0       # activations
    dot_flops: float = 0.0
    result_bytes: float = 0.0              # memory-traffic proxy

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    def as_dict(self) -> Dict[str, object]:
        return {"collective_bytes": dict(self.collective_bytes),
                "collective_counts": dict(self.collective_counts),
                "collective_bytes_ag2d": self.collective_bytes_ag2d,
                "collective_bytes_other2d": self.collective_bytes_other2d,
                "collective_bytes_hi": self.collective_bytes_hi,
                "dot_flops": self.dot_flops, "result_bytes": self.result_bytes}


def _op_flops(func, args, kwargs, out) -> int:
    from torch.utils.flop_counter import flop_registry
    f = flop_registry.get(func._overloadpacket)
    return 0 if f is None else int(f(*args, **kwargs, out_val=out))


# a layout copy and a view that the schema does not mark as one, whose
# outputs ``result_bytes`` leaves out
_LAYOUT_OPS = ("aten::clone", "aten::_unsafe_view")


class _Counter(TorchDispatchMode):
    """Adds each aten op's product FLOPs and output bytes (views and layout
    copies excluded) into ``sink``, except inside a kernel wrapper; as the
    ``tally_hooks`` sink, counts the collectives and the kernels' reports."""

    def __init__(self, sink: Tally):
        super().__init__()
        self.sink = sink
        self.quiet = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.quiet:
            self.sink.dot_flops += _op_flops(func, args, kwargs, out)
            if not func.is_view and func._schema.name not in _LAYOUT_OPS:
                self.sink.result_bytes += sum(float(t.numel() * t.element_size())
                                              for t in tree_flatten(out)[0]
                                              if isinstance(t, torch.Tensor))
        return out

    def collective(self, kind: str, result: torch.Tensor) -> None:
        if kind not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}")
        t = self.sink
        b = float(result.numel() * result.element_size())
        t.collective_bytes[kind] = t.collective_bytes.get(kind, 0.0) + b
        t.collective_counts[kind] = t.collective_counts.get(kind, 0.0) + 1
        if result.dim() <= 2:
            if kind == "all-gather":
                t.collective_bytes_ag2d += b
            else:
                t.collective_bytes_other2d += b
        else:
            t.collective_bytes_hi += b

    def kernel(self, plain: Callable, kernel: Callable, args, kwargs):
        flops, nbytes = plain_count(plain, *args, **kwargs)
        self.quiet += 1
        try:
            out = kernel(*args, **kwargs)
        finally:
            self.quiet -= 1
        self.sink.dot_flops += flops
        self.sink.result_bytes += nbytes
        return out


def _key(args, kwargs) -> tuple:
    def one(a):
        if isinstance(a, torch.Tensor):
            return ("T", tuple(a.shape), tuple(a.stride()), a.dtype)
        return ("V", a)
    return (tuple(one(a) for a in args), tuple(sorted((k, one(v)) for k, v in kwargs.items())))


def _unkey(k):
    # the arguments' strides too, as the kernel was given them
    if k[0] == "T":
        return torch.empty_strided(k[1], k[2], dtype=k[3], device="meta")
    return k[1]


@functools.lru_cache(maxsize=4096)
def _plain_count(fn: Callable, key: tuple) -> Tuple[float, float]:
    sink = Tally()
    with _disable_current_modes():
        args, kwargs = [_unkey(k) for k in key[0]], {n: _unkey(k) for n, k in key[1]}
        with _Counter(sink):
            fn(*args, **kwargs)
    return sink.dot_flops, sink.result_bytes


def plain_count(fn: Callable, *args, **kwargs) -> Tuple[float, float]:
    """(product FLOPs, result bytes) of ``fn(*args, **kwargs)`` as the
    counter counts them, run on meta tensors of the arguments' shapes,
    strides and dtypes (no data), with any counting mode of the caller set
    aside."""
    return _plain_count(fn, _key(args, kwargs))


@contextlib.contextmanager
def tally() -> Iterator[Tally]:
    """Count the step run inside: aten products and output bytes through a
    dispatch mode (the autograd engine carries it into the backward), the
    kernels' reports and the collectives into the ``Tally`` yielded."""
    t = Tally()
    counter = _Counter(t)
    prev = tally_hooks.set_sink(counter)
    if prev is not None:
        tally_hooks.set_sink(prev)
        raise RuntimeError("a tally is already running")
    try:
        with counter:
            yield t
    finally:
        tally_hooks.set_sink(None)
