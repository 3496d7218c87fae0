"""Twins of tests/test_checkpoint.py on the port's ``CheckpointManager``
alone: round-trip, an asynchronous save, garbage collection, a restore of a
chosen step and a restore from an empty directory."""
import numpy as np
import pytest
import torch

from repro_torch.runtime.checkpoint import CheckpointManager


def _state(seed):
    gen = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=gen),
                       "nested": {"b": torch.arange(5.0)}},
            "opt_state": {"mu": torch.ones((8, 4))}}


def _leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state(0)
    mgr.save(10, st)
    step, restored = mgr.restore(like=st)
    assert step == 10
    for a, b in zip(_leaves(st), _leaves(restored)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state(1)
    mgr.save(5, st, blocking=False)
    step, restored = mgr.restore(like=st)   # restore waits for the writer
    assert step == 5
    np.testing.assert_array_equal(restored["params"]["w"].numpy(), st["params"]["w"].numpy())


def test_gc_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    assert mgr.latest_step() == 4
    steps = sorted(int(p.name.split("_")[1]) for p in tmp_path.glob("step_*"))
    assert steps == [3, 4]


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    s1, s2 = _state(1), _state(2)
    mgr.save(1, s1)
    mgr.save(2, s2)
    step, restored = mgr.restore(like=s1, step=1)
    assert step == 1
    np.testing.assert_array_equal(restored["params"]["w"].numpy(), s1["params"]["w"].numpy())


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        mgr.restore(like=_state(0))
