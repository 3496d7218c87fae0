"""The training driver: ``runtime/elastic.py::ElasticRuntime.step`` on
numpy batches, whole steps until the window closes.

Set-up goes through the control plane as ``launch/train.py::run_training``
does (a fleet, a scheduler, MATCHALLOCATE, ``bind``), then the weights of
the seed are drawn into the bound model's masters and the mix's checked
steps run through the same ``step`` the window calls, on the same feed:
they warm up every shape and give the program's readings, which the
reference follows after the window. The window's steps continue the
stream. There are no grow, shrink or failure events.
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from .. import compare, weights
from ..cell import Cell
from ..reference import common, model as ref_model
from ..tokens import TokenSource


class Driver:
    numbers = staticmethod(compare.train_numbers)

    def __init__(self, cell: Cell):
        self.cell = cell
        mix = cell.mix
        self.b, self.s = mix["batch"], mix["seq_len"]
        self.checked = mix["checked_steps"]
        self.opt = mix["optimizer"]
        self.source = TokenSource(mix["tokens"], cell.vocab(), cell.seed)
        self.rt = None
        self.prog: Dict = {}
        self.steps = 0
        self.window_s = 0.0
        self.losses = []

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Step ``step``'s rows (from 1): tokens and their next tokens."""
        t = self.source.draw(0, step, (self.b, self.s + 1))
        return {"tokens": t[:, :-1], "labels": t[:, 1:]}

    # -------------------------------------------------------------- #
    def setup(self) -> None:
        from repro_torch.core.external import TPUSliceProvider
        from repro_torch.core.graph import build_tpu_fleet
        from repro_torch.core.scheduler import SchedulerInstance
        from repro_torch.models.config import ShapeConfig
        from repro_torch.optim.adamw import OptConfig
        from repro_torch.runtime.elastic import ElasticRuntime

        cell, dev = self.cell, self.cell.device
        fl = cell.mix["fleet"]
        fleet = build_tpu_fleet(pods=fl["pods"], racks_per_pod=fl["racks_per_pod"],
                                nodes_per_rack=fl["nodes_per_rack"],
                                chips_per_node=fl["chips_per_node"], device=dev)
        sched = SchedulerInstance("top", fleet, external=TPUSliceProvider())
        opt = OptConfig(**{k: v for k, v in self.opt.items()})
        self.rt = ElasticRuntime(sched, cell.arch(), ShapeConfig("train", self.s, self.b, "train"),
                                 chip_type="chip", opt=opt, device=dev)
        if not self.rt.allocate(fl["start_chips"]):
            raise RuntimeError("the initial MATCHALLOCATE failed")
        self.rt.bind(torch.Generator(device=dev).manual_seed(0))
        cell.mark("control plane and bind")
        weights.fill_program(self.rt.model.masters(), cell.layout, cell.seed)
        cell.sync()
        cell.mark("weights")
        losses = []
        for step in range(1, self.checked + 1):
            losses.append(float(self.rt.step(self.batch(step))["loss"]))
            if step == 1:
                # the moment after one step from zero is (1 - b1) times the
                # gradient the optimizer took
                self.prog["grad_norms"] = {k: common.norm(m) / (1 - self.opt["b1"])
                                           for k, m in self.rt.opt_state.mu.items()}
        self.prog["losses"] = losses
        cell.sync()
        cell.mark(f"{self.checked} checked steps")
        cell.mark_setup_peak()
        masters = self.rt.model.masters()
        self.prog["change_norms"] = {k: self._change(k, masters[k]) for k in cell.layout}
        cell.restart_peak()
        cell.mark("readings")

    def _change(self, name: str, p: torch.Tensor) -> float:
        p0 = weights.draw(self.cell.layout[name], self.cell.seed, name, p.device)
        total = sum(float(torch.sum((a - b).double() ** 2))
                    for a, b in zip(p.reshape(-1).split(1 << 24), p0.reshape(-1).split(1 << 24)))
        return total ** 0.5

    # -------------------------------------------------------------- #
    def window(self, seconds: float = None, count: int = None) -> None:
        """Whole steps until ``seconds`` have passed (or ``count`` steps),
        then a synchronize: the time of all of them."""
        first = self.checked + 1
        losses, n = [], 0
        clock = self.cell.clock
        with self.cell.tracer.window():
            t0 = time.perf_counter()
            clock.tick()
            while (n < count) if count is not None else (time.perf_counter() - t0 < seconds):
                losses.append(self.rt.step(self.batch(first + n))["loss"])
                clock.tick()
                n += 1
            self.cell.sync()
            self.window_s = time.perf_counter() - t0
        self.steps = n
        self.losses = [float(x) for x in losses]

    def end_to_end(self) -> Dict[str, float]:
        return {"train_tokens_per_s": self.steps * self.b * self.s / self.window_s}

    def counts(self):
        return self.steps, sum(1 for x in self.losses if not np.isfinite(x))

    def layer_context(self) -> dict:
        return {"kind": "train", "units": self.steps, "batch": self.b, "seq_len": self.s}

    def readings(self) -> dict:
        return self.prog

    def release(self) -> None:
        self.rt = None

    # -------------------------------------------------------------- #
    def reference(self, fp8: bool = False) -> dict:
        """The reference's readings over the same checked steps, from the
        seed's weights drawn again."""
        cell, dev = self.cell, self.cell.device
        common.no_tf32()
        params = {k: weights.draw(leaf, cell.seed, k, dev) for k, leaf in cell.layout.items()}
        batches = []
        for step in range(1, self.checked + 1):
            bt = self.batch(step)
            batches.append((torch.from_numpy(bt["tokens"]).to(dev),
                            torch.from_numpy(bt["labels"]).to(dev)))
        out = ref_model.train_readings(
            params, cell.sizes, batches, self.opt,
            initial=lambda k: weights.draw(cell.layout[k], cell.seed, k, dev), fp8=fp8)
        out["quiet_leaves"] = compare.quiet_leaves(out)
        return out
