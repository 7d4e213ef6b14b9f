"""llama3.2-3b — small llama3 [hf:meta-llama/Llama-3.2-1B family] (the
values of ``repro.configs.llama3_2_3b``)."""
from repro_torch.models.common import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        arch_id="llama3.2-3b", family="dense",
        num_layers=28, d_model=3072, vocab_size=128256,
        num_heads=24, num_kv_heads=8, head_dim=128, d_ff=8192,
        block_pattern=("dense",), rope="rope", rope_theta=500_000.0,
        norm="rmsnorm", act="swiglu", tie_embeddings=True,
    )
    base.update(kw)
    return ModelConfig(**base)
