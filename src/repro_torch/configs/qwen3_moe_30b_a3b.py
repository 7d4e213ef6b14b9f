"""qwen3-moe-30b-a3b — 128 experts, top-8 [hf:Qwen/Qwen3-30B-A3B]
(the values of ``repro.configs.qwen3_moe_30b_a3b``)."""
from repro_torch.models.common import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        arch_id="qwen3-moe-30b-a3b", family="moe",
        num_layers=48, d_model=2048, vocab_size=151936,
        num_heads=32, num_kv_heads=4, head_dim=128, d_ff=768,
        num_experts=128, top_k=8, capacity_factor=1.25,
        block_pattern=("moe",), rope="rope", rope_theta=1e6,
        norm="rmsnorm", act="swiglu",
    )
    base.update(kw)
    return ModelConfig(**base)
