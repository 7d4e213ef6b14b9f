"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 1:2
[arXiv:2402.19427] (the values of ``repro.configs.recurrentgemma_9b``).
38 layers = 12 × (rec, rec, lattn) + a 2-layer rec tail."""
from repro_torch.models.common import ModelConfig


def get_config(**kw) -> ModelConfig:
    base = dict(
        arch_id="recurrentgemma-9b", family="hybrid",
        num_layers=38, d_model=4096, vocab_size=256000,
        num_heads=16, num_kv_heads=1, head_dim=256, d_ff=12288,
        block_pattern=("rec", "rec", "lattn"), window=2048,
        rope="rope", rope_theta=10000.0, norm="rmsnorm", act="geglu",
        rglru_expand=1,
    )
    base.update(kw)
    return ModelConfig(**base)
