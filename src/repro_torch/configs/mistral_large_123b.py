"""mistral-large-123b [dense]: 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b", family="dense", n_layers=88,
        d_model=12288, n_heads=96, n_kv_heads=8, d_head=128, d_ff=28672,
        vocab=32768, grad_accum=2,  # §Perf: halves FSDP gather traffic, fits HBM
        # kv_dup left at 1: duplicating an 88-layer cache costs 2x12GB —
        # over budget (measured 29.5GB/dev); decode stays seq-sharded
        rope="rope", rope_theta=1_000_000.0, act="swiglu",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mistral-large-123b-smoke", family="dense", n_layers=3,
        d_model=64, n_heads=8, n_kv_heads=2, d_head=8, d_ff=160, vocab=256,
        rope="rope", act="swiglu", attn_chunk_q=32, attn_chunk_k=32,
        dtype="float32",
    )
