"""internvl2-26b [vlm]: InternViT (stub frontend) + InternLM2 backbone.
[arXiv:2404.16821; hf]"""

from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab_size=92553,
        n_vis_tokens=256,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="internvl2-26b-smoke", family="vlm",
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512,
        n_vis_tokens=16,
    )
