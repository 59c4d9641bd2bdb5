"""mamba2-2.7b [ssm]: 64L d_model=2560, attention-free, ssm_state=128 —
SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
        n_heads=0, n_kv_heads=0, d_head=0, d_ff=0, vocab=50288,  # 50280→pad16
        rope="none",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, d_head=0, d_ff=0, vocab=256, rope="none",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=32),
        dtype="float32",
    )
