"""ElasticRuntime: scheduler allocations bound to devices.

The port of ``repro/runtime/elastic.py``. This is where the paper's
control plane meets the data plane. A training job is one job submitted
through the :class:`~repro_torch.core.api.Instance` facade; it holds a
resource allocation (a subgraph of the hierarchical scheduler's resource
graph) for its whole life. Elasticity events map as:

* **grow**   — a malleable grow request *through the job queue*
  (``JobHandle.grow``: MATCHGROW via the scheduler hierarchy, bursting
  through the External API if the local fleet is exhausted, with a typed
  GROW event flowing back), then a rebind to the devices now usable;
* **shrink** — a malleable shrink request through the queue
  (``JobHandle.shrink``: bottom-up release with exact queue/scheduler
  accounting and a SHRINK event), then a rebind;
* **failure** — subtractive transform ejecting the failed node, then a
  grow request for a replacement (spare pool first, then external), then
  a rebind.

Where JAX binds a mesh of ``min(allocated chips, jax.devices())`` devices
and re-shards the state onto it, the port binds the list of usable local
devices (``torch.cuda.device_count()`` on a card, one CPU otherwise) and
trains on the first of them: one card, so a resize changes the bound
list's length and not where the state lives. A rebind to the same device
keeps the model and its state where they are (at full width a second
copy would not fit the card); it still records its ``rebind`` event and
rebuilds the step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.api import Instance, JobHandle
from ..core.jobspec import Jobspec, ResourceReq
from ..core.queue import JobState
from ..core.scheduler import SchedulerInstance
from ..core.transform import remove_subgraph
from ..device import resolve_device
from ..models.config import ArchConfig, ShapeConfig
from ..models.model import Model, make_model
from ..optim.adamw import OptConfig, OptState


@dataclass
class ElasticEvent:
    kind: str            # grow | shrink | eject | rebind | restore
    t: float
    chips_before: int
    chips_after: int
    detail: str = ""


class ElasticRuntime:
    """Bind a scheduler allocation to devices; survive resizes."""

    def __init__(self, scheduler: Union[SchedulerInstance, Instance],
                 cfg: ArchConfig,
                 shape: ShapeConfig, jobid: str = "train-job",
                 model_axis: int = 1, chip_type: str = "core",
                 opt: Optional[OptConfig] = None,
                 device: Union[str, torch.device] = "cuda"):
        # everything control-plane goes through the Instance facade; a
        # bare SchedulerInstance (back-compat) is wrapped in one
        self.api = scheduler if isinstance(scheduler, Instance) \
            else Instance(scheduler)
        self.scheduler = self.api.scheduler
        self.handle: Optional[JobHandle] = None
        self.cfg = cfg
        self.shape = shape
        self.jobid = jobid
        self.model_axis = model_axis
        self.chip_type = chip_type
        self.opt = opt
        self.device = resolve_device(device)
        self.events: List[ElasticEvent] = []
        self.mesh: Optional[List[torch.device]] = None     # the bound devices
        self.model: Optional[Model] = None
        self._train_step = None
        self.opt_state: Optional[OptState] = None

    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        """The fp32 masters, {state_dict name: tensor} (JAX's flatten order)."""
        return None if self.model is None else self.model.masters()

    # ---------------------------------------------------------------- #
    def chips_allocated(self) -> int:
        alloc = self.scheduler.allocations.get(self.jobid)
        if alloc is None:
            return 0
        g = self.scheduler.graph
        return sum(1 for p in alloc.paths
                   if p in g and g.vertex(p).type == self.chip_type)

    def _local_devices(self) -> List[torch.device]:
        if self.device.type == "cuda":
            return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        return [self.device]

    def _usable_devices(self) -> int:
        """Devices this process may bind (min of allocation and local)."""
        chips = self.chips_allocated()
        avail = len(self._local_devices())
        usable = min(chips, avail)
        # keep divisibility by the model axis and the batch
        usable -= usable % self.model_axis
        while usable > self.model_axis and \
                self.shape.global_batch % (usable // self.model_axis):
            usable -= self.model_axis
        return max(usable, self.model_axis)

    # ---------------------------------------------------------------- #
    def bind(self, generator: Optional[torch.Generator] = None) -> None:
        """(Re)bind the job to the devices its allocation makes usable: the
        model and its optimizer state are built on first use (the masters
        drawn from ``generator``) and kept where they are otherwise (the
        first local device is the first bound one at every size)."""
        n = self._usable_devices()
        before = 0 if self.mesh is None else len(self.mesh)
        self.mesh = self._local_devices()[:n]
        dev = self.mesh[0]
        if self.model is None:
            self.model = make_model(self.cfg, device=dev, opt=self.opt)
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            self.model.init_params(generator)
            self.opt_state = self.model.init_opt()
        self._train_step = self.model.train_step
        self.events.append(ElasticEvent(
            "rebind", time.time(), before, len(self.mesh),
            f"devices={len(self.mesh)} model_axis={self.model_axis}"))

    # ---------------------------------------------------------------- #
    def allocate(self, chips: int) -> bool:
        """Submit the training job (strictly local MATCHALLOCATE for
        the initial placement; it runs until cancelled)."""
        js = Jobspec(resources=[ResourceReq(self.chip_type, chips)])
        self.handle = self.api.submit(js, jobid=self.jobid,
                                      alloc_id=self.jobid, grow=False,
                                      dispatch=True)
        if self.handle.state is not JobState.RUNNING:
            self.handle.cancel()
            self.handle = None
            return False
        return True

    def grow(self, chips: int) -> bool:
        """Malleable grow through the queue: MATCHGROW more chips (with
        a GROW event flowing back), rebind."""
        if self.handle is None:
            return False
        before = self.chips_allocated()
        js = Jobspec(resources=[ResourceReq(self.chip_type, chips)])
        if not self.handle.grow(js):
            return False
        self.events.append(ElasticEvent(
            "grow", time.time(), before, self.chips_allocated(),
            f"+{chips} {self.chip_type}"))
        self.bind()
        return True

    def shrink(self, chips: int) -> bool:
        """Malleable shrink through the queue: relinquish ``chips``
        chips (bottom-up release, SHRINK event, queue accounting and
        scheduler allocation kept in agreement)."""
        if self.handle is None:
            return False
        alloc = self.scheduler.allocations.get(self.jobid)
        if alloc is None:
            return False
        g = self.scheduler.graph
        victims = [p for p in alloc.paths
                   if p in g and g.vertex(p).type == self.chip_type]
        if len(victims) - chips < self.model_axis:
            return False
        before = self.chips_allocated()
        if not self.handle.shrink(paths=victims[-chips:]):
            return False
        self.events.append(ElasticEvent(
            "shrink", time.time(), before, self.chips_allocated(),
            f"-{chips} {self.chip_type}"))
        self.bind()
        return True

    # ---------------------------------------------------------------- #
    def eject_and_replace(self, node_path: str,
                          replace: bool = True) -> bool:
        """Failure path: subtractive transform for the dead node, then a
        MATCHGROW for replacement resources."""
        g = self.scheduler.graph
        if node_path not in g:
            return False
        lost = [p for p in g.subtree(node_path)
                if g.vertex(p).type == self.chip_type]
        before = self.chips_allocated()
        remove_subgraph(g, [node_path], jobid=self.jobid)
        alloc = self.scheduler.allocations.get(self.jobid)
        if alloc is not None:
            alloc.paths = [p for p in alloc.paths if p in g]
        if self.handle is not None:
            # the failure mutated the graph out from under the queue:
            # resync the job record so accounting stays exact
            self.handle.job.paths = [p for p in self.handle.job.paths
                                     if p in g]
        self.events.append(ElasticEvent(
            "eject", time.time(), before, self.chips_allocated(), node_path))
        ok = True
        if replace and lost:
            js = Jobspec(resources=[ResourceReq(self.chip_type, len(lost))])
            ok = bool(self.handle.grow(js)) if self.handle is not None \
                else bool(self.scheduler.match_grow(js, self.jobid))
        self.bind()
        return ok

    # ---------------------------------------------------------------- #
    def step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """One training step on a numpy batch ({"tokens", "labels"}, or a
        stub frontend's {"embeds", "labels"}): integer arrays as int64,
        embeddings in their own dtype."""
        dev = self.mesh[0]
        on_dev = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.asarray(v))
            on_dev[k] = t.to(dev) if t.is_floating_point() else t.to(dev, torch.long)
        self.opt_state, metrics = self._train_step(self.opt_state, on_dev)
        return metrics
