"""Model configuration of the port (a copy of :mod:`repro.models.config`:
the dataclasses and the parameter counts the memory reckoning uses),
covering all ten architectures of the registry."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    num_shared_experts: int = 0  # deepseek: 1 shared expert
    first_k_dense: int = 0       # deepseek: first 3 layers are dense
    router_scale: bool = True    # normalize top-k router weights
    dispatch: str = "dense"      # "dense" (one-hot einsum) | "sorted" (paper)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 SSD."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    qkv_bias: bool = False
    rope: str = "rope"  # rope | mrope | none (learned/none for encoder)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    act: str = "swiglu"  # swiglu | gelu
    causal: bool = True
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): one shared attention block re-used every k ssm layers
    hybrid_shared_period: int = 0
    hybrid_lora_rank: int = 0
    # deepseek multi-token prediction: one extra MTP head/layer
    mtp: bool = False
    # modality frontend stub: model consumes precomputed (B,S,D) embeddings
    frontend_stub: bool = False
    # training-time knobs
    remat: bool = True
    attn_chunk_q: int = 1024
    attn_chunk_k: int = 2048
    scan_layers: bool = True
    dtype: str = "bfloat16"
    # mesh axis names for activation-sharding hints (None = no constraints,
    # e.g. single-device smoke tests); set by the launcher/dry-run.
    mesh_axes: tuple | None = None
    # token-chunk size for EP MoE dispatch (bounds all_to_all buffers)
    moe_chunk: int = 8192
    # sequence parallelism: shard the residual stream's sequence dim over
    # "model" between blocks (Megatron-SP) — divides saved-activation
    # memory by the TP degree; attention/mlp gather on entry.
    sp: bool = True
    # gradient accumulation microbatches (1 = none); activation memory
    # scales down by this factor at the cost of re-running the backward.
    grad_accum: int = 1
    # decode-cache kv-head duplication factor: store each kv head `kv_dup`
    # times so kv_heads·kv_dup divides the TP degree — trades cache memory
    # for clean head-sharded decode attention (vs seq-sharded cache).
    kv_dup: int = 1

    @property
    def d_inner_ssm(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner_ssm // self.ssm.head_dim if self.ssm else 0

    def param_count(self) -> int:
        """Approximate parameter count N (for MODEL_FLOPS = 6·N·D)."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        total = V * d  # embed
        if not self.tie_embeddings:
            total += V * d
        per_layer_attn = 0
        if self.family not in ("ssm",):
            if self.mla:
                m = self.mla
                qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                per_layer_attn = (
                    d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d
                )
            else:
                per_layer_attn = (
                    d * self.n_heads * self.d_head
                    + 2 * d * self.n_kv_heads * self.d_head
                    + self.n_heads * self.d_head * d
                )
        ssm_per_layer = 0
        if self.ssm:
            di, ns, g = self.d_inner_ssm, self.ssm.d_state, self.ssm.n_groups
            ssm_per_layer = (
                d * (2 * di + 2 * g * ns + self.n_ssm_heads)  # in_proj
                + di * d  # out_proj
                + (di + 2 * g * ns) * self.ssm.d_conv
                + 2 * self.n_ssm_heads
            )
        mlp_per_layer = 3 * d * self.d_ff if self.act == "swiglu" else 2 * d * self.d_ff
        total_layers = 0
        for layer in range(L):
            if self.family == "ssm":
                total_layers += ssm_per_layer
            elif self.family == "hybrid":
                total_layers += ssm_per_layer
            elif self.moe and layer >= self.moe.first_k_dense:
                e_ff = self.moe.d_ff_expert
                total_layers += per_layer_attn + 3 * d * e_ff * (
                    self.moe.num_experts + self.moe.num_shared_experts
                ) + d * self.moe.num_experts
            else:
                total_layers += per_layer_attn + mlp_per_layer
        if self.family == "hybrid" and self.hybrid_shared_period:
            shared_attn = 4 * d * self.n_heads * self.d_head + 3 * d * self.d_ff
            total_layers += shared_attn  # one shared block
        return total + total_layers

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.n_layers
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer_attn = 0
        if self.mla:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            per_layer_attn = (
                d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
            )
        else:
            per_layer_attn = (
                d * self.n_heads * self.d_head
                + 2 * d * self.n_kv_heads * self.d_head
                + self.n_heads * self.d_head * d
            )
        for layer in range(L):
            if layer < self.moe.first_k_dense:
                total += per_layer_attn + 3 * d * self.d_ff
            else:
                active_e = self.moe.top_k + self.moe.num_shared_experts
                total += per_layer_attn + 3 * d * self.moe.d_ff_expert * active_e
                total += d * self.moe.num_experts  # router
        return total
