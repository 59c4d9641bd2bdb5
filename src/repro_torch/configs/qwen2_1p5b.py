"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, d_head=128, d_ff=8960, vocab=151936,
        qkv_bias=True, rope="rope", rope_theta=1_000_000.0, act="swiglu",
        tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-smoke", family="dense", n_layers=2, d_model=48,
        n_heads=6, n_kv_heads=2, d_head=8, d_ff=96, vocab=256,
        qkv_bias=True, rope="rope", act="swiglu", tie_embeddings=True,
        attn_chunk_q=32, attn_chunk_k=32, dtype="float32",
    )
