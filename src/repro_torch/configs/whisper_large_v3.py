"""whisper-large-v3 [audio]: enc-dec transformer backbone; conv/audio frontend
is a stub (input_specs supplies precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""

from ..models.common import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-large-v3", family="encdec",
        n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
        d_ff=5120, vocab_size=51866,
        n_enc_layers=32, enc_seq=1500, act="gelu",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-large-v3-smoke", family="encdec",
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab_size=512,
        n_enc_layers=2, enc_seq=48, act="gelu",
    )
