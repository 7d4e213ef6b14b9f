"""qwen2-vl-7b — VLM decoder backbone with M-RoPE [arXiv:2409.12191] (the
values of ``repro.configs.qwen2_vl_7b``).

The vision encoder and projector are a stub, as in the reference: the
inputs carry patch embeddings (B, Nv, d_model) as the sequence's prefix
and 3-D M-RoPE position ids.
"""
from repro_torch.models.common import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        arch_id="qwen2-vl-7b", family="vlm",
        num_layers=28, d_model=3584, vocab_size=152064,
        num_heads=28, num_kv_heads=4, head_dim=128, d_ff=18944,
        block_pattern=("dense",), rope="mrope", rope_theta=1e6,
        use_bias=True, norm="rmsnorm", act="swiglu",
    )
    base.update(kw)
    return ModelConfig(**base)
