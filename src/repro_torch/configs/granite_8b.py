"""granite-8b — llama-arch dense code model [arXiv:2405.04324] (the values
of ``repro.configs.granite_8b``)."""
from repro_torch.models.common import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        arch_id="granite-8b", family="dense",
        num_layers=36, d_model=4096, vocab_size=49152,
        num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
        block_pattern=("dense",), rope="rope", rope_theta=10_000_000.0,
        norm="rmsnorm", act="swiglu",
    )
    base.update(kw)
    return ModelConfig(**base)
