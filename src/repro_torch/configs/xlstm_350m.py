"""xlstm-350m [ssm]: sLSTM + mLSTM blocks (7:1).  [arXiv:2405.04517; unverified]"""

from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="xlstm-350m", family="xlstm",
        n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304,
        slstm_every=8, xlstm_chunk=256,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="xlstm-350m-smoke", family="xlstm",
        n_layers=4, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=512,
        slstm_every=2, xlstm_chunk=32,
    )
