"""gemma-2b [arXiv:2403.08295] — dense decoder, MQA (kv=1), GeGLU,
head_dim=256.  18L, d_model=2048, 8 heads, d_ff=16384, vocab=256000."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="gemma-2b",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256_000,
    layout=(("attn", "mlp"),),
    activation="geglu",
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="gemma-2b-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=512,
    layout=(("attn", "mlp"),),
    activation="geglu",
)
