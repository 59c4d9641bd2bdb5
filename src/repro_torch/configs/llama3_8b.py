"""llama3-8b [dense]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b", family="dense", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_head=128, d_ff=14336, vocab=128256,
        rope="rope", rope_theta=500_000.0, act="swiglu",
        kv_dup=2,  # §Perf: head-sharded decode cache (−97% decode collectives)
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3-8b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
        rope="rope", rope_theta=500_000.0, act="swiglu",
        attn_chunk_q=32, attn_chunk_k=32, dtype="float32",
    )
