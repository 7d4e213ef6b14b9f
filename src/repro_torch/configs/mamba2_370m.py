"""mamba2-370m — SSD (state-space duality), attention-free
[arXiv:2405.21060] (the values of ``repro.configs.mamba2_370m``)."""
from repro_torch.models.common import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        arch_id="mamba2-370m", family="ssm",
        num_layers=48, d_model=1024, vocab_size=50280,
        d_ff=0, num_heads=0, num_kv_heads=0, head_dim=0,
        ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_chunk=256,
        block_pattern=("ssd",), rope="none", tie_embeddings=True,
        norm="rmsnorm",
    )
    base.update(kw)
    return ModelConfig(**base)
