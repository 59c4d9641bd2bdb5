"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 — llama-arch, code [arXiv:2405.04324]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b", family="dense", n_layers=52, d_model=6144,
        n_heads=48, n_kv_heads=1, d_head=128, d_ff=24576, vocab=49152,
        rope="rope", rope_theta=10_000.0, act="gelu",  # 2-matrix MLP ⇒ 20B
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=8, n_kv_heads=1, d_head=8, d_ff=128, vocab=256,
        rope="rope", act="swiglu", attn_chunk_q=32, attn_chunk_k=32,
        dtype="float32",
    )
