"""stablelm-12b [dense]: GQA.  [hf:stabilityai/stablelm-2-1_6b; hf]"""

from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="stablelm-12b", family="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=13824, vocab_size=100352,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="stablelm-12b-smoke", family="dense",
        n_layers=3, d_model=128, n_heads=8, n_kv_heads=2,
        d_ff=256, vocab_size=512,
    )
