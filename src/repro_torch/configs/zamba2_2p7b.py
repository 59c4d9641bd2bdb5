"""zamba2-2.7b [hybrid]: 54 Mamba2 layers d_model=2560 + shared attention
block (32H, d_ff=10240) re-used every 6 layers with per-invocation LoRA,
ssm_state=64 [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, d_head=80, d_ff=10240, vocab=32000,
        rope="rope",
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        hybrid_shared_period=6, hybrid_lora_rank=128,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=256, rope="rope",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=32),
        hybrid_shared_period=2, hybrid_lora_rank=8,
        attn_chunk_q=32, attn_chunk_k=32, dtype="float32",
    )
