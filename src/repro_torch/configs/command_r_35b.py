"""command-r-35b — GQA, no-bias dense [hf:CohereForAI/c4ai-command-r-v01]
(the values of ``repro.configs.command_r_35b``)."""
from repro_torch.models.common import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        arch_id="command-r-35b", family="dense",
        num_layers=40, d_model=8192, vocab_size=256000,
        num_heads=64, num_kv_heads=8, head_dim=128, d_ff=22528,
        block_pattern=("dense",), rope="rope", rope_theta=10_000.0,
        norm="rmsnorm", act="swiglu", use_bias=False,
    )
    base.update(kw)
    return ModelConfig(**base)
