"""qwen2-vl-2b [vlm]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — M-RoPE, dynamic resolution; the vision tower is a STUB
(input_specs provides patch embeddings + 3-component M-RoPE position ids)
[arXiv:2409.12191]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, d_head=128, d_ff=8960, vocab=151936,
        qkv_bias=True, rope="mrope", rope_theta=1_000_000.0, act="swiglu",
        tie_embeddings=True, frontend_stub=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-smoke", family="vlm", n_layers=2, d_model=48,
        n_heads=6, n_kv_heads=2, d_head=16, d_ff=96, vocab=256,
        qkv_bias=True, rope="mrope", act="swiglu", tie_embeddings=True,
        frontend_stub=True, attn_chunk_q=32, attn_chunk_k=32, dtype="float32",
    )
