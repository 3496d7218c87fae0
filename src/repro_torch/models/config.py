"""Architecture configuration (all 10 assigned architectures use this).

A copy of ``repro.models.config``: the port imports nothing of the JAX
package, so it keeps its own copy of these plain dataclasses.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    """Config for one architecture (decoder-style LM backbone)."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    mlp_act: str = "swiglu"          # swiglu | relu2 | gelu
    rope: str = "rope"               # rope | mrope | abs_sin | none
    rope_theta: float = 10_000.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # 1 = every layer is MoE; 2 = interleaved
    moe_d_ff: int = 0                # expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    moe_impl: str = "dispatch"       # dispatch | dense
    moe_shared: int = 0              # number of shared experts (Llama-4: 1)
    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_groups: int = 1
    # hybrid (Zamba2-style): shared attention block every k SSM layers
    shared_attn_every: int = 0
    # frontend: token | audio_stub | vision_stub
    frontend: str = "token"
    # attention
    sliding_window: int = 0          # 0 = full causal
    # numerics
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # optimizer choice for the big ones
    optimizer: str = "adamw"         # adamw | adafactor
    remat: bool = True
    # §Perf beyond-paper optimizations (baseline keeps them off)
    cast_params_once: bool = False   # bf16 cast BEFORE the layer scan:
    #   FSDP all-gathers move bf16 instead of f32 (half the bytes)
    onehot_ce: bool = False          # one-hot CE instead of
    #   take_along_axis (kills the s32 gather/all-to-all in the loss)
    seq_sharded_loss: bool = False   # logits stay [b, s->model, v-full]:
    #   the head is gathered ONCE per step instead of cascading
    #   partial-sum all-reduces over the model axis
    ssm_seq_sharded: bool = False    # Mamba2 layers stay sequence-
    #   sharded through in_proj + causal conv (halo exchange); only the
    #   SSD scan runs head-sharded, entered/exited via all-to-all — vs
    #   the baseline's full-sequence activation all-gathers per layer
    mlp_seq_sharded: bool = False    # constrain MLP intermediates to
    #   stay sequence-sharded (weights gather fully instead of the
    #   activations — wins when seq >> d_ff buffer)
    moe_ep2d: bool = False           # a2a MoE keeps expert weights
    #   f-sliced over 'data' (no per-layer FSDP weight gather); tokens
    #   all-gather over 'data' into the expert compute and the partial
    #   outputs reduce-scatter back — wins when expert weights per
    #   device exceed the per-shard token buffer (llama4's 2 GiB/layer)
    prefill_last_logits: bool = False  # prefill projects only the
    #   final position through the LM head (removes the [b,s,vocab]
    #   logits buffer at 32K context)
    grad_accum: int = 1              # microbatches per step (gradient
    #   accumulation): divides activation memory by the factor at the
    #   cost of re-running the FSDP weight gathers per microbatch
    bf16_grads: bool = False         # mixed-precision step: grads are
    #   taken w.r.t. a bf16 compute copy of the params, so weight
    #   all-gathers AND gradient all-reduces move bf16; the fp32 master
    #   stays in the optimizer (standard mixed-precision recipe)

    # -------------------------------------------------------------- #
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def n_params(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        e, hd = self.d_model, self.hd
        total = self.vocab * e * (1 if self.tie_embeddings else 2)
        per_attn = e * (self.n_heads * hd) * 2 + e * (self.n_kv_heads * hd) * 2
        mlp_mults = 3 if self.mlp_act == "swiglu" else 2
        per_dense_mlp = mlp_mults * e * self.d_ff
        per_moe = self.n_experts * mlp_mults * e * self.expert_ff
        per_ssm = 0
        if self.ssm_state:
            di, ng, ns = self.d_inner, self.ssm_groups, self.ssm_state
            proj_out = 2 * di + 2 * ng * ns + self.ssm_heads
            per_ssm = e * proj_out + di * e + di * 4  # in/out proj + conv
        for i in range(self.n_layers):
            if self.family in ("ssm",):
                total += per_ssm
            elif self.family == "hybrid":
                total += per_ssm
            else:
                total += per_attn
                if self.is_moe and i % self.moe_every == (self.moe_every - 1):
                    total += per_moe + e * self.n_experts  # + router
                else:
                    total += per_dense_mlp
        if self.family == "hybrid" and self.shared_attn_every:
            total += per_attn + per_dense_mlp  # one shared block
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.n_params()
        e = self.d_model
        mlp_mults = 3 if self.mlp_act == "swiglu" else 2
        per_moe_all = self.n_experts * mlp_mults * e * self.expert_ff
        per_moe_active = self.top_k * mlp_mults * e * self.expert_ff
        n_moe_layers = sum(1 for i in range(self.n_layers)
                           if i % self.moe_every == (self.moe_every - 1))
        return self.n_params() - n_moe_layers * (per_moe_all - per_moe_active)

    # -------------------------------------------------------------- #
    def reduced(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if self.shared_attn_every else 2)
            if not self.shared_attn_every else 4,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            moe_d_ff=32 if self.is_moe else 0,
            vocab=256,
            n_experts=4 if self.is_moe else 0,
            top_k=min(self.top_k, 2) if self.is_moe else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            shared_attn_every=2 if self.shared_attn_every else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            dtype="float32",
            remat=False,
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (seq_len × global_batch × mode)."""

    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def smoke_shape(mode: str = "train") -> ShapeConfig:
    return ShapeConfig(f"smoke_{mode}", 32, 2, mode)
