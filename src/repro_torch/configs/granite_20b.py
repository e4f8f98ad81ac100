"""granite-20b [arXiv:2405.04324] — llama-arch code model with MQA.
52L, d_model=6144, 48H (kv=1), d_ff=24576, vocab=49152."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="granite-20b",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24_576, vocab_size=49_152,
    layout=(("attn", "mlp"),),
    activation="gelu",          # granite-20b-code uses gpt-bigcode-style MLP
)

SMOKE = ModelConfig(
    name="granite-20b-smoke",
    n_layers=2, d_model=192, n_heads=6, n_kv_heads=1,
    d_ff=384, vocab_size=512,
    layout=(("attn", "mlp"),),
    activation="gelu",
)
