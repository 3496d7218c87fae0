"""The per-layer readings of a traced window, for the readers under
``metrics/``. A kernel family's share of its roofline is the sum of the
least times of its calls (``roofline``'s bounds, from the cell's shapes)
over the sum of the device time of its kernels. A family names the kernels
it reads by substrings of their names; a call is counted by one kernel
that each call launches once. Nothing found: None.

``run`` is what ``cell.run`` hands a reader: the driver's ``kind``
("train" or "prefill"), ``units`` (steps or batches), ``batch`` and
``seq_len``, the configuration's ``port`` sizes (``reference.sizes``), the
window's ``window_s`` and ``busy_s``, and ``kernels`` {name: [launches,
device seconds]}."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

from . import roofline

SSD_KERNELS = ("ssd_scores_kernel", "ssd_chunk_kernel", "ssd_bwd_")
ATTENTION_KERNELS = ("flash_fwd", "flash_bwd")


def launches(kernels: Dict[str, list], marker: str) -> int:
    return sum(int(v[0]) for name, v in kernels.items() if marker in name)


def seconds(kernels: Dict[str, list], patterns: Sequence[str]) -> float:
    return sum(v[1] for name, v in kernels.items() if any(p in name for p in patterns))


def share(kernels: Dict[str, list], patterns: Sequence[str], calls) -> Optional[float]:
    """``calls``: [(marker, bound seconds of one call)]."""
    spent = seconds(kernels, patterns)
    if spent <= 0:
        return None
    bound = sum(launches(kernels, marker) * each for marker, each in calls)
    return 100.0 * bound / spent if bound > 0 else None


def ssd_share(run: dict, kind: str) -> Optional[float]:
    """The SSD scan's kernels (``kernels/ssd_scan.py``, ``csrc/ssd_chunk.cu``)
    in a ``kind`` run. A forward call is ``ssd_scores_kernel`` +
    ``ssd_chunk_kernel``, counted by the latter (in a training step once in
    the forward and once in remat's recompute); a backward call is
    ``ssd_scores_kernel`` again + the five ``ssd_bwd_*`` kernels, counted by
    ``ssd_bwd_head_kernel``; bounds ``roofline.ssd_fwd`` and ``ssd_bwd`` at
    the cell's [b, s] and the configuration's heads, state and chunk."""
    p = run["port"]
    if run["kind"] != kind or not p.get("ssm_state"):
        return None
    di = p["ssm_expand"] * p["d_model"]
    shape = (run["batch"], run["seq_len"], di // p["ssm_head_dim"], p["ssm_head_dim"],
             p["ssm_groups"], p["ssm_state"], p["ssm_chunk"])
    calls = [("ssd_chunk_kernel", roofline.ssd_fwd(*shape)[0])]
    if kind == "train":
        calls.append(("ssd_bwd_head_kernel", roofline.ssd_bwd(*shape)[0]))
    return share(run["kernels"], SSD_KERNELS, calls)


def attention_share(run: dict, kind: str) -> Optional[float]:
    """The attention kernels (``kernels/flash_attention.py``,
    ``csrc/flash_attention.cu``) in a ``kind`` run. A forward call is one
    ``flash_fwd*`` kernel (in a training step once in the forward and once
    in remat's recompute); a backward call is ``flash_bwd_delta_kernel``
    and the dK/dV and dQ kernels, counted by the first; bounds
    ``roofline.attention_fwd`` and ``attention_bwd``, causal, at the cell's
    [b, s] and the configuration's heads in bf16."""
    p = run["port"]
    if run["kind"] != kind or not p.get("n_heads"):
        return None
    s = run["seq_len"]
    d = p.get("head_dim") or p["d_model"] // p["n_heads"]
    shape = (run["batch"], p["n_heads"], p["n_kv_heads"], s, s, d)
    calls = [("flash_fwd", roofline.attention_fwd(*shape)[0])]
    if kind == "train":
        calls.append(("flash_bwd_delta", roofline.attention_bwd(*shape)[0]))
    return share(run["kernels"], ATTENTION_KERNELS, calls)


def step_mfu(run: dict, kind: str) -> Optional[float]:
    """The model FLOPs of the window's steps or batches over the window's
    host-clock length (profiler on), as a share of the bf16 peak: a
    training step ``roofline.train_flops``, a prefill batch
    ``roofline.forward_flops`` (the head counted at every position, as the
    program computes it there)."""
    if run["kind"] != kind or run["units"] == 0:
        return None
    flops = (roofline.train_flops if kind == "train" else roofline.forward_flops)(
        run["port"], run["batch"], run["seq_len"])
    return 100.0 * flops * run["units"] / run["window_s"] / roofline.BF16_FLOPS


def idle_share(run: dict, kind: str) -> Optional[float]:
    """The share of the window in which no kernel, copy or set ran on the
    device: 1 - busy / window, from the profiler's device activity."""
    if run["kind"] != kind or run["window_s"] <= 0 or run["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])
