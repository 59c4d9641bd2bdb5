"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504 —
encoder-only; the conv feature extractor is a STUB (input_specs provides
precomputed frame embeddings) [arXiv:2106.07447]."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="encoder", n_layers=48, d_model=1280,
        n_heads=16, n_kv_heads=16, d_head=80, d_ff=5120, vocab=512,  # 504 targets padded to /16
        rope="rope", act="gelu", causal=False, frontend_stub=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="encoder", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=64,
        rope="rope", act="gelu", causal=False, frontend_stub=True,
        attn_chunk_q=32, attn_chunk_k=32, dtype="float32",
    )
