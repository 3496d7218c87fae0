"""Tiny versions of the benchmark's cells for the CPU: the configuration's
widths cut to its family's ``TINY`` sizes (``reference/<family>.py``) and
the mix's lengths cut, so that a run takes seconds. The benchmark's own
files are never edited."""
from __future__ import annotations

import copy

import torch

from portbench.reference import family, sizes


def tiny(bench, workload: str, dtype: str = "bfloat16"):
    """(config, mix) of ``workload`` cut for the CPU."""
    entry = bench.workload(workload)
    config = copy.deepcopy(bench.config(entry["config"]))
    config["port"].update(family(sizes(config)).TINY, dtype=dtype)
    config["vocab_size"] = 250
    mix = copy.deepcopy(bench.mix(entry["traffic"]))
    if mix["driver"] == "train":
        mix.update(seq_len=32, batch=2)
    else:
        mix.update(prompt_len=32, decode_slots=4, clients=2, checked_requests=6)
    return config, mix


CPU = torch.device("cpu")
