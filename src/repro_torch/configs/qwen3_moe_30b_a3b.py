"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) vocab=151936,
MoE 128 experts top-8, expert d_ff=768 [hf:Qwen/Qwen3-30B-A3B]; the
repository's configuration (no q/k norm), as in :mod:`repro.configs`."""
from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=4, d_head=128, d_ff=6144, vocab=151936,
        rope="rope", rope_theta=1_000_000.0, act="swiglu",
        moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768,
                      dispatch="sorted_ep", capacity_factor=1.0),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
        rope="rope", act="swiglu",
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      dispatch="sorted"),
        attn_chunk_q=32, attn_chunk_k=32, dtype="float32",
    )
