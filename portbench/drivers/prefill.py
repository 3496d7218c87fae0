"""The prefill driver: a prefill instance of disaggregated serving.

``clients`` clients in a closed loop each send a prompt of ``prompt_len``
tokens and wait for its first token; the waiting prompts go as one batch
through ``models/model.py::Model.prefill_step``, and the prompt cache goes
by ``launch/serve.py::splice_cache`` into decode buffers of ``prompt_len
+ decode_slots`` positions allocated at set-up, where a decode instance
would read it. A request's time to first token runs from its send to its
token's arrival on the host. Set-up builds the model as
``launch/serve.py::run_serving`` does, draws the seed's weights into its
masters, and serves two batches of warm-up prompts, which are not counted.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import compare, weights
from ..cell import Cell
from ..reference import common, family, model as ref_model
from ..tokens import TokenSource

PROMPTS, WARM = 1, 2          # token streams
WARM_BATCHES = 2


class Driver:
    numbers = staticmethod(compare.prefill_numbers)

    def __init__(self, cell: Cell):
        self.cell = cell
        mix = cell.mix
        self.n, self.s = mix["clients"], mix["prompt_len"]
        self.source = TokenSource(mix["tokens"], cell.vocab(), cell.seed)
        self.model = self.cache = None
        self.ttft: List[float] = []
        self.served: List[int] = []
        self.rows: List[np.ndarray] = []
        self.window_s = 0.0
        self.rounds = 0

    def prompts(self, stream: int, first: int) -> np.ndarray:
        """The ``clients`` prompts from request ``first`` on, [n, s] ids."""
        return np.stack([self.source.draw(stream, first + i, (self.s,)) for i in range(self.n)])

    # -------------------------------------------------------------- #
    def setup(self) -> None:
        from repro_torch.models.config import ShapeConfig
        from repro_torch.models.model import make_model

        cell = self.cell
        self.model = make_model(cell.arch(), device=cell.device)
        cell.mark("model")
        weights.fill_program(self.model.masters(), cell.layout, cell.seed)
        self.cache = self.model.init_cache(
            ShapeConfig("serve", self.s + cell.mix["decode_slots"], self.n, "decode"))
        cell.sync()
        cell.mark("weights and buffers")
        for i in range(WARM_BATCHES):
            self._serve(self.prompts(WARM, i * self.n))
        cell.sync()
        cell.mark("warm-up batches")
        cell.mark_setup_peak()
        cell.restart_peak()

    def _serve(self, ids: np.ndarray):
        """One batch: the prompts to the device, the prefill, the cache
        handed over, the first tokens (and their logits) on the host."""
        from repro_torch.launch import serve

        tokens = torch.from_numpy(ids).to(self.cell.device)
        logits, pcache = self.model.prefill_step(tokens)
        serve.splice_cache(self.cache, pcache)
        del pcache
        last = logits[:, -1, :]
        tok = last.argmax(dim=-1).cpu()
        rows = last.float().cpu().numpy()
        return tok.numpy(), rows

    # -------------------------------------------------------------- #
    def window(self, seconds: float = None, count: int = None) -> None:
        """Batches until ``seconds`` have passed (or ``count`` batches): each
        client sends its next prompt once it has its first token."""
        rounds = 0
        clock = self.cell.clock
        with self.cell.tracer.window():
            t0 = time.perf_counter()
            clock.tick()
            while (rounds < count) if count is not None else (time.perf_counter() - t0 < seconds):
                # each client has its prompt ready; it is sent when the
                # client has its previous answer
                ids = self.prompts(PROMPTS, rounds * self.n)
                sent = time.perf_counter()
                tok, rows = self._serve(ids)
                done = time.perf_counter()
                clock.tick()
                self.ttft += [done - sent] * self.n
                self.served += [int(t) for t in tok]
                self.rows += list(rows)
                rounds += 1
            self.window_s = time.perf_counter() - t0
        self.rounds = rounds

    def end_to_end(self) -> Dict[str, float]:
        return {"ttft_ms_p95": 1e3 * float(np.percentile(self.ttft, 95))}

    def counts(self):
        bad = sum(1 for r, t in zip(self.rows, self.served)
                  if not (np.isfinite(r).all() and 0 <= t < self.cell.port["vocab"]))
        return len(self.served), bad

    def layer_context(self) -> dict:
        return {"kind": "prefill", "units": self.rounds, "batch": self.n, "seq_len": self.s}

    def sample(self) -> List[int]:
        """The requests compared: the last batch's (whose cache is in the
        buffers) and a draw from the seed of the others."""
        total = len(self.served)
        last = list(range(total - self.n, total))
        want = min(self.cell.mix["checked_requests"], total) - self.n
        rng = np.random.default_rng([self.cell.seed, 7])
        rest = sorted(rng.choice(total - self.n, size=max(want, 0), replace=False).tolist())
        return last + rest

    def readings(self) -> dict:
        picked = self.sample()
        cache = family(self.cell.sizes).program_cache(self.cache, self.s)
        return {"sample": picked, "served": {r: self.served[r] for r in picked},
                "rows": {r: self.rows[r] for r in picked}, "cache": cache}

    def release(self) -> None:
        self.model = None

    # -------------------------------------------------------------- #
    def reference(self, fp8: bool = False) -> dict:
        """The reference's last logits for the sampled requests, in
        batches of ``clients`` (the last batch first, with its cache), from
        the seed's weights drawn again. With ``fp8`` (the control) its
        served tokens are its own argmax."""
        cell, dev = self.cell, self.cell.device
        common.no_tf32()
        picked = self.sample()
        params = {k: weights.draw(leaf, cell.seed, k, dev) for k, leaf in cell.layout.items()}
        rows, cache = {}, None
        for i in range(0, len(picked), self.n):
            part = picked[i:i + self.n]
            ids = np.stack([self.source.draw(PROMPTS, r, (self.s,)) for r in part])
            out, kv = ref_model.prefill(params, cell.sizes, torch.from_numpy(ids).to(dev), fp8,
                                        want_cache=(i == 0))
            if i == 0:
                cache = kv
            for r, row in zip(part, out.cpu().numpy()):
                rows[r] = row
        del params
        return {"rows": rows, "cache": cache,
                "served": {r: int(np.argmax(row)) for r, row in rows.items()}}
