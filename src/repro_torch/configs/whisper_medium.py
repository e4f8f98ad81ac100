"""whisper-medium [arXiv:2212.04356] — encoder-decoder audio backbone.
24+24L, d_model=1024, 16H (kv=16), d_ff=4096, vocab=51865, layernorm/GELU.
Mel+conv frontend is stubbed: the encoder consumes precomputed frame
embeddings (B, 1500, d_model)."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="whisper-medium",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51_865,
    layout=(("attn_x", "mlp"),),
    activation="gelu", norm="layernorm",
    n_enc_layers=24, enc_seq=1500,
    frontend="audio",
)

SMOKE = ModelConfig(
    name="whisper-medium-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    layout=(("attn_x", "mlp"),),
    activation="gelu", norm="layernorm",
    n_enc_layers=2, enc_seq=64,
    frontend="audio",
)
