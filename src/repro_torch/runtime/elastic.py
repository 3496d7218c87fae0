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
and re-shards the state onto it, the port binds ranks of a
``torch.distributed`` world, one device a rank (``cuda:{local rank}`` on a
card, the CPU under gloo): a ("data", "model") ``DeviceMesh`` over ranks
``[0, n)`` (``launch/mesh.py``'s ``make_mesh_for``), built once for each
n and kept, since a mesh's groups live as long as the world. Every rank of
the world runs the same control plane (the Instance, its queue and
scheduler are deterministic, so every rank takes the same decisions) and
calls ``bind`` at every resize; ranks ``[0, n)`` are bound, the others
hold no state and skip steps until the next rebind.

The state has JAX's Zero-3 layout (``Model.param_shardings`` /
``opt_shardings``): a bound rank holds 1/n of each split master and
moment and the small leaves whole. The first bind draws each leaf whole,
one at a time, and keeps this rank's slice, so the values do not depend
on n. A rebind from n to m ranks moves one leaf at a time: the old ranks
gather it over its axes, rank 0 broadcasts it to the world when
ranks join, and each new rank keeps its slice: the counterpart of JAX's
``device_put(params, psh)`` onto the new mesh. The new shards are
allocated as the old ones are freed, so a rebind's peak is the larger of
the two layouts' state plus about one whole leaf. The mesh is (n / m, m) for
a model axis of m (``model_axis``, as JAX's ``make_mesh_for(n,
model_axis)``; the usable count stays a multiple of m). A bound rank of
coordinate (d, r) takes its rows [d B/(n/m), (d+1) B/(n/m)) of the
step's batch of B (its rows of each of ``grad_accum``'s microbatches)
and its positions [r S/m, (r+1) S/m): the model ranks split one sequence,
the data ranks the batch. The layers gather each split leaf over its axes
where they use it and reduce-scatter its gradient, attention gathers K
and V over "model", the Mamba2 scan runs head-split, the MoE layer runs
on the mesh (``models/transformer.py``); the gradients are summed over
the mesh and divided by the data size before the optimizer: JAX's
global-batch mean (``_mean_over_data``). The reported loss is that mean
too. ``full_state`` gathers the whole state onto the host of rank 0 for
a checkpoint.

Without a process group the world is one device (the first CUDA card, or
the CPU) holding every leaf whole, and a rebind keeps the model and its
state where they are (at full width a second copy would not fit the
card); it still records its ``rebind`` event and rebuilds the step.
JAX's ``run_training`` always uses a model axis of 1
(``repro/launch/train.py:58``), and so does the port's.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.api import Instance, JobHandle
from ..core.jobspec import Jobspec, ResourceReq
from ..core.queue import JobState
from ..core.scheduler import SchedulerInstance
from ..core.transform import remove_subgraph
from ..device import resolve_device
from ..launch.mesh import make_mesh_for
from ..models.config import ArchConfig, ShapeConfig
from ..models.model import Model, make_model
from ..optim.adamw import OptConfig, OptState
from ..parallel.sharding import Rules, ShardingCtx
from ..tally_hooks import span
from .checkpoint import _flatten, _unflatten


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
        self.device_mesh = None        # their ("data", "model") DeviceMesh, None in a world of one
        self._meshes: Dict[int, Any] = {}      # every mesh built so far, by its device count
        self.model: Optional[Model] = None
        self._train_step = None
        self.opt_state: Optional[OptState] = None

    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        """This rank's shards of the fp32 masters, {state_dict name: tensor}
        (JAX's flatten order); None on a rank that is not bound."""
        return None if self.model is None else self.model.masters()

    @params.setter
    def params(self, shards: Dict[str, torch.Tensor]) -> None:
        """Copy this rank's shards into the masters (e.g. a restore through
        ``shardings=``)."""
        with torch.no_grad():
            for name, t in self.model.masters().items():
                t.copy_(shards[name])
        self.model._compute = None

    def full_state(self) -> Optional[Dict[str, Any]]:
        """The whole masters and optimizer state on the host of rank 0, the
        checkpoint's writer, gathered one leaf at a time: {"params",
        "opt_state"} as a checkpoint holds them. Every bound rank calls it
        (the gathers are collectives over the mesh); the others take part,
        keep no host copy and get None, as does a rank that is not bound."""
        if self.model is None:
            return None
        keep = self._rank() == 0
        params = self.model.full_params(keep)
        opt_state = self.model.full_opt_state(self.opt_state, keep)
        return {"params": params, "opt_state": opt_state} if keep else None

    # ---------------------------------------------------------------- #
    def chips_allocated(self) -> int:
        alloc = self.scheduler.allocations.get(self.jobid)
        if alloc is None:
            return 0
        g = self.scheduler.graph
        return sum(1 for p in alloc.paths
                   if p in g and g.vertex(p).type == self.chip_type)

    @staticmethod
    def _distributed() -> bool:
        return dist.is_available() and dist.is_initialized()

    def _world(self) -> int:
        return dist.get_world_size() if self._distributed() else 1

    def _rank(self) -> int:
        return dist.get_rank() if self._distributed() else 0

    def _rank_device(self) -> torch.device:
        """This rank's device: ``cuda:{LOCAL_RANK}`` (one process a card) in
        a world on cards, the CPU under gloo, ``self.device`` without a
        process group."""
        if self._distributed() and self.device.type == "cuda":
            local = int(os.environ.get("LOCAL_RANK", self._rank() % torch.cuda.device_count()))
            return torch.device("cuda", local)
        return self.device

    def _local_devices(self) -> List[torch.device]:
        """One device for each rank of the default group when
        ``torch.distributed`` is initialised; else the local CUDA cards,
        or the CPU."""
        if self._distributed():
            if self.device.type == "cuda":
                n = torch.cuda.device_count()
                return [torch.device("cuda", r % n) for r in range(self._world())]
            return [torch.device("cpu")] * self._world()
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

    @property
    def bound(self) -> bool:
        """Whether this rank is one of the bound ranks ``[0, n)``."""
        return self.mesh is not None and self._rank() < len(self.mesh)

    # ---------------------------------------------------------------- #
    def bind(self, generator: Optional[torch.Generator] = None) -> None:
        """(Re)bind the job to the devices its allocation makes usable.
        Every rank of the world calls it. The model and its optimizer state
        are built on the first bind, each bound rank drawing every master
        whole from ``generator`` and keeping its shard; a rebind to another
        mesh moves them onto its layout (``_reshard``), and one to the same
        mesh keeps them where they are."""
        n = self._usable_devices()
        before = 0 if self.mesh is None else len(self.mesh)
        devices = self._local_devices()[:n]
        dev = self._rank_device()
        old_mesh, self.device_mesh = self.device_mesh, self._mesh(n)
        bound = self.device_mesh is None or self._rank() < n
        if before == 0:
            if bound:
                self.model = make_model(self.cfg, ShardingCtx(Rules(), self.device_mesh),
                                        device=dev, opt=self.opt)
                if generator is None:
                    generator = torch.Generator(device=dev).manual_seed(0)
                self.model.init_params(generator)
                self.opt_state = self.model.init_opt()
        elif self.device_mesh is not old_mesh:
            self._reshard(before, n)
        self.mesh = devices
        self._train_step = None if self.model is None else self.model.train_step
        self.events.append(ElasticEvent(
            "rebind", time.time(), before, len(self.mesh),
            f"devices={len(self.mesh)} model_axis={self.model_axis}"))

    def _mesh(self, n: int):
        """The mesh of n devices, built on first use (by every rank) and
        kept: building one creates process groups that live until the
        world is destroyed, so a job that resizes often reuses them."""
        if not self._distributed():
            return None
        if n not in self._meshes:
            self._meshes[n] = make_mesh_for(n, self.model_axis, self._rank_device().type)
        return self._meshes[n]

    @torch.no_grad()
    def _reshard(self, before: int, n: int) -> None:
        """Move the state from the ``before`` ranks of the old mesh onto the
        layout of the current mesh of n ranks, one leaf at a time (every rank
        of the world calls it): the old ranks gather the leaf over its axes
        and free their shard of it; when ranks join, rank 0
        broadcasts it to the world; each new rank copies out its shard. The
        new model is built on "meta" and takes its shards at the end
        (``Model.adopt``), so a shard is allocated only once the old shard
        of its leaf is gone: the peak is the larger of the old and the new
        state, plus one whole leaf, one new shard and the gather's buffer of
        one old shard. Ranks that are no longer bound drop their state."""
        dev = self._rank_device()
        old, old_state = self.model, self.opt_state
        new = new_like = None
        if self._rank() < n:
            new = make_model(self.cfg, ShardingCtx(Rules(), self.device_mesh),
                             device="meta", opt=self.opt)
            new_like = new.init_opt()
        ref = make_model(self.cfg, device="meta", opt=self.opt)      # shapes only
        names = list(ref.param_specs())
        joiners = n > before
        shapes = list(ref.param_shapes().values()) + _flatten(ref.opt_shapes())[1:]
        olds, kept = [], []
        if old is not None:
            params = dict(old.named_parameters())
            olds = [params[k] for k in names] + _flatten(old_state)[1:]
            old_sh = list(old.param_shardings().values()) + _flatten(old.opt_shardings())[1:]
            del params
        if new is not None:
            new_sh = list(new.param_shardings().values()) + _flatten(new.opt_shardings())[1:]
        for i, (shape, dtype) in enumerate(shapes):
            full = part = None
            if old is not None:
                # a whole leaf is the old tensor itself: the alias keeps its storage
                full = old.gather(olds[i], old_sh[i]).detach()
                olds[i].data = torch.empty(0, dtype=dtype, device=dev)     # the old shard goes
            if joiners:
                if full is None:
                    full = torch.empty(shape, dtype=dtype, device=dev)
                dist.broadcast(full, src=0)
            if new is not None:
                part = new_sh[i].shard(full)
                kept.append(full if part.shape == full.shape
                            else part.clone(memory_format=torch.contiguous_format))
            full = part = None       # the whole leaf (``part`` views it) goes before the next
        step = 0 if old_state is None else old_state.step
        if joiners:
            t = torch.tensor([step], dtype=torch.int64, device=dev)
            dist.broadcast(t, src=0)
            step = int(t.item())
        self.model = self.opt_state = None
        del old, old_state, olds
        if new is not None:
            new.adopt(dict(zip(names, kept[:len(names)])))
            self.opt_state = _unflatten(new_like, [step] + kept[len(names):])
        self.model = new

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
        embeddings in their own dtype. Across ranks, every rank passes the
        same global batch [B, S, ...]; a bound rank of mesh coordinate (d,
        r) on an (n, m) mesh trains on its rows [d B/n, (d+1) B/n) (with
        ``grad_accum`` k, on its rows [i B/k + d B/(k n), i B/k + (d+1)
        B/(k n)) of each microbatch i, so that microbatch i holds the global
        microbatch's rows, as in JAX) and its positions [r S/m, (r+1) S/m),
        and a rank that is not bound skips the step (its loss is NaN).

        The step is the span ``train.step`` (its ``step`` the optimizer's
        step it takes), the batch's copies to the device ``train.upload``."""
        step = self.opt_state.step + 1 if self.opt_state is not None else None
        with span("train.step", step=step):
            return self._step(batch)

    def _step(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        dev = self._rank_device()
        reduce = None
        rows = cols = slice(None)
        if self.device_mesh is not None:
            if not self.bound:
                return {"loss": torch.tensor(float("nan"))}
            (n, m), (d, r) = self.device_mesh.shape, self.device_mesh.get_coordinate()
            k = max(self.cfg.grad_accum, 1)
            B, S = self.shape.global_batch, self.shape.seq_len
            if B % (k * n):
                raise ValueError(f"global batch {B} does not split into {k} microbatches "
                                 f"over {n} data ranks")
            if S % m:
                raise ValueError(f"sequence {S} does not split over {m} model ranks")
            rows = np.arange(B).reshape(k, n, B // (k * n))[:, d].reshape(-1)
            cols = slice(r * S // m, (r + 1) * S // m)
            reduce = self._mean_over_data
        on_dev = {}
        with span("train.upload"):
            for key, v in batch.items():
                t = torch.from_numpy(np.ascontiguousarray(np.asarray(v)[rows][:, cols]))
                on_dev[key] = t.to(dev) if t.is_floating_point() else t.to(dev, torch.long)
        self.opt_state, metrics = self._train_step(self.opt_state, on_dev, reduce=reduce)
        return metrics

    def _mean_over_data(self, loss: torch.Tensor, grads: Dict[str, torch.Tensor]):
        """This rank's loss and gradients, its parts of the global batch's,
        made the global batch's mean over the mesh (``Model.mean_over_batch``)."""
        return self.model.mean_over_batch(loss, grads)
