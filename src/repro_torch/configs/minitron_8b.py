"""minitron-8b [arXiv:2407.14679] — pruned Nemotron-4.
32L, d_model=4096, 32H (GQA kv=8), d_ff=16384, vocab=256000."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="minitron-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16_384, vocab_size=256_000,
    layout=(("attn", "mlp"),),
    activation="relu",          # nemotron uses squared-relu; relu^2 ~ relu here
)

SMOKE = ModelConfig(
    name="minitron-smoke",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    layout=(("attn", "mlp"),),
    activation="relu",
)
