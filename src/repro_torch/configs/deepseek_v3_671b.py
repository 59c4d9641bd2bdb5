"""deepseek-v3-671b [moe]: 61L d_model=7168 128H vocab=129280 — MLA,
1 shared + 256 routed experts top-8 (expert d_ff=2048), first 3 layers
dense (d_ff=18432), MTP [arXiv:2412.19437]."""
from repro_torch.models.config import ModelConfig, MoEConfig, MLAConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
        n_heads=128, n_kv_heads=128, d_head=128, d_ff=18432, vocab=129280,
        grad_accum=8,
        moe_chunk=4096,
        rope="rope", rope_theta=10_000.0, act="swiglu", mtp=True,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                      num_shared_experts=1, first_k_dense=3,
                      dispatch="sorted_ep"),
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_head=16, d_ff=128, vocab=256,
        rope="rope", act="swiglu", mtp=True,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32,
                      num_shared_experts=1, first_k_dense=1,
                      dispatch="sorted"),
        attn_chunk_q=32, attn_chunk_k=32, dtype="float32",
    )
