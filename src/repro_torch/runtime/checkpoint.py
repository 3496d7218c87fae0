"""Topology-independent checkpointing (the port of
``repro/runtime/checkpoint.py``), in the same layout: a directory
``step_<8 digits>`` per step holding one ``<tree>.npz`` per saved tree
(leaves ``leaf_0``, ``leaf_1``, ... in JAX's flatten order) and a
``manifest.json``; written to a temporary directory and published by an
atomic rename; the newest ``keep`` steps kept.

A tree is a dict (flattened in sorted key order, as JAX flattens dicts),
an ``OptState`` (step, then the first moments, then the second), a
tensor, or an int (the step, saved as a 0-d int32 like JAX's). So the
port's state dict and optimizer state and JAX's param tree and
``OptState`` flatten to the same leaves in the same order, and a
checkpoint written by either package restores into the other. The
manifest's ``treedef`` is a description only: a restore takes the
structure from ``like`` and matches the leaves by count and order.

The files hold whole leaves whatever the layout they were saved from
(the Zero-3 runtime gathers them over every mesh axis they are split
over first, ``ElasticRuntime.full_state``); ``restore(like,
shardings=...)`` slices each onto the current layout, as JAX's does with
its shardings, so a checkpoint of an (n, m) mesh restores on any other
(data, model) mesh.
Saves can run on a background thread so the training loop is not
blocked.
"""
from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..optim.adamw import OptState


def _flatten(tree: Any) -> List[Any]:
    if isinstance(tree, OptState):
        return [tree.step] + _flatten(tree.mu) + _flatten(tree.nu)
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    return [tree]


def _describe(tree: Any) -> str:
    if isinstance(tree, OptState):
        return f"OptState(step, mu={_describe(tree.mu)}, nu={_describe(tree.nu)})"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    return "*"


def _unflatten(like: Any, leaves: List[np.ndarray], shardings: Optional[List[Any]] = None
               ) -> Any:
    """``like``'s structure with its leaves replaced, in order, by
    ``leaves`` (consumed from the front): arrays as tensors on ``like``'s
    device and in its dtype, tensors as they are, ints as ints.
    ``shardings``, in the same order (consumed alike), slices each whole
    leaf to this rank's shard where it is not None."""
    if isinstance(like, OptState):
        step = int(leaves.pop(0))
        if shardings is not None:
            shardings.pop(0)
        mu = _unflatten(like.mu, leaves, shardings)
        return OptState(step=step, mu=mu, nu=_unflatten(like.nu, leaves, shardings))
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves, shardings) for k in sorted(like)}
    a = leaves.pop(0)
    sh = None if shardings is None else shardings.pop(0)
    if sh is not None:
        a = sh.shard(a)
    if isinstance(like, torch.Tensor):
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"leaf shape {a.shape} != {tuple(like.shape)}")
        if isinstance(a, torch.Tensor):
            return a
        return torch.from_numpy(np.ascontiguousarray(a)).to(like.device, like.dtype)
    return type(like)(a)


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._async_thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- #
    def save(self, step: int, state: Dict[str, Any], blocking: bool = True) -> Path:
        """``state`` is a dict of trees (e.g. params=, opt_state=). The
        leaves are copied to the host before this returns."""
        host = {name: ([_host(l) for l in _flatten(tree)], _describe(tree))
                for name, tree in state.items()}
        if blocking:
            return self._write(step, host)
        self.wait()
        self._async_thread = threading.Thread(
            target=self._write, args=(step, host), daemon=True)
        self._async_thread.start()
        return self.dir / f"step_{step:08d}"

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _write(self, step: int, host: Dict[str, Tuple[List[np.ndarray], str]]) -> Path:
        out = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}_{time.time_ns()}"
        tmp.mkdir(parents=True, exist_ok=True)
        manifest: Dict[str, Any] = {"step": step, "trees": {}}
        for name, (leaves, treedef) in host.items():
            manifest["trees"][name] = {"n_leaves": len(leaves), "treedef": treedef}
            np.savez(tmp / f"{name}.npz", **{f"leaf_{i}": l for i, l in enumerate(leaves)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if out.exists():  # re-save of the same step: replace
            for f in out.iterdir():
                f.unlink()
            out.rmdir()
        tmp.rename(out)  # atomic publish
        self._gc()
        return out

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*"))
        for old in ckpts[:-self.keep]:
            for f in old.iterdir():
                f.unlink()
            old.rmdir()

    # ---------------------------------------------------------------- #
    def latest_step(self) -> Optional[int]:
        ckpts = sorted(self.dir.glob("step_*"))
        if not ckpts:
            return None
        return int(ckpts[-1].name.split("_")[1])

    def restore(self, like: Dict[str, Any], shardings: Optional[Dict[str, Any]] = None,
                step: Optional[int] = None) -> Tuple[int, Dict[str, Any]]:
        """Restore the trees named in ``like``, each onto the structure,
        devices and dtypes of its tree there; the leaf counts must agree.
        ``shardings`` (the same structure, e.g. ``Model.param_shardings()``
        and ``opt_shardings()``) slices each leaf onto the current layout:
        ``like`` then holds this rank's shards."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        src = self.dir / f"step_{step:08d}"
        out: Dict[str, Any] = {}
        for name, tree in like.items():
            n = len(_flatten(tree))
            with np.load(src / f"{name}.npz") as data:
                if len(data.files) != n:
                    raise ValueError(f"{name}: the checkpoint has {len(data.files)} leaves, "
                                     f"the tree {n}")
                leaves = [data[f"leaf_{i}"] for i in range(n)]
            sh = None
            if shardings is not None and name in shardings:
                sh = _flatten(shardings[name])
            out[name] = _unflatten(tree, leaves, sh)
        return step, out
