"""Faults planted in the program under a driver, to show that the check
catches them: a step that returns its state unchanged; half of the batch
left out (the mean taken over the rest); a token or an answer altered
where it is produced. (The exchange between chips is not a fault a
one-chip cell can have.) Each is a context manager that patches the
program's module and restores it; the benchmark's runs plant none.
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def _patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def planted(kind: str, fault: str):
    """The patch of ``fault`` for a driver of ``kind`` ("train" or "prefill")."""
    from repro_torch.launch import serve
    from repro_torch.models import model as model_mod

    Model = model_mod.Model
    if kind == "train" and fault == "unchanged":
        def apply_updates(params, grads, state, cfg, shards=None):
            return type(state)(step=state.step + 1, mu=state.mu, nu=state.nu)
        return _patched(model_mod, "apply_updates", apply_updates)
    if kind == "train" and fault == "half_batch":
        vag = Model.value_and_grad

        def value_and_grad(self, batch):
            half = {k: t[: max(t.shape[0] // 2, 1)] for k, t in batch.items()}
            return vag(self, half)
        return _patched(Model, "value_and_grad", value_and_grad)
    if kind == "train" and fault == "altered":
        step = Model.train_step

        def train_step(self, opt_state, batch, reduce=None):
            state, metrics = step(self, opt_state, batch, reduce)
            return state, {"loss": metrics["loss"] * 1.01}
        return _patched(Model, "train_step", train_step)
    if kind == "prefill" and fault == "unchanged":
        return _patched(serve, "splice_cache", lambda cache, pcache, ctx=None: None)
    if kind == "prefill" and fault == "half_batch":
        prefill = Model.prefill_step

        def prefill_step(self, tokens=None, *, embeds=None):
            h = max(tokens.shape[0] // 2, 1)
            logits, cache = prefill(self, tokens[:h])
            reps = -(-tokens.shape[0] // h)
            logits = logits.repeat(reps, 1, 1)[: tokens.shape[0]]
            # every cache is [L, b, ...]: the batch is its second axis
            cache = {k: v.repeat(1, reps, *[1] * (v.dim() - 2))[:, : tokens.shape[0]]
                     for k, v in cache.items()}
            return logits, cache
        return _patched(Model, "prefill_step", prefill_step)
    if kind == "prefill" and fault == "altered":
        prefill = Model.prefill_step

        def prefill_step(self, tokens=None, *, embeds=None):
            logits, cache = prefill(self, tokens)
            logits = logits.clone()
            top = logits.argmax(dim=-1, keepdim=True)
            other = (top + 1) % logits.shape[-1]
            logits.scatter_(-1, other, logits.amax(dim=-1, keepdim=True) + 1.0)
            return logits, cache
        return _patched(Model, "prefill_step", prefill_step)
    raise ValueError(f"no fault {fault!r} for a {kind} driver")

