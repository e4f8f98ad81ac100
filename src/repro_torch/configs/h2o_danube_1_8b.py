"""h2o-danube-1.8b [arXiv:2401.16818] — llama+mistral mix with sliding
window attention.  24L, d_model=2560, 32H (GQA kv=8), d_ff=6912,
vocab=32000, window=4096 (mistral-style SWA -> long_500k capable)."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-1.8b",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32_000,
    layout=(("swa", "mlp"),), window=4096,
    activation="swiglu",
)

SMOKE = ModelConfig(
    name="h2o-danube-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    layout=(("swa", "mlp"),), window=16,
    activation="swiglu",
)
