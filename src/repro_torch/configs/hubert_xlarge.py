"""hubert-xlarge — encoder-only audio backbone [arXiv:2106.07447] (the
values of ``repro.configs.hubert_xlarge``).

The convolutional feature extractor is a stub, as in the reference: the
inputs carry frame embeddings (B, T, d_model); this config is the
transformer that consumes them.  Encoder-only: no decode step.
"""
from repro_torch.models.common import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        arch_id="hubert-xlarge", family="audio",
        num_layers=48, d_model=1280, vocab_size=504,
        num_heads=16, num_kv_heads=16, head_dim=80, d_ff=5120,
        block_pattern=("dense",), causal=False, rope="none",
        norm="layernorm", act="gelu", use_bias=True,
    )
    base.update(kw)
    return ModelConfig(**base)
