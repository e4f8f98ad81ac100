"""deepseek-moe-16b [arXiv:2401.06066] — fine-grained MoE: 64 routed
experts top-6 + 2 shared, expert hidden 1408; first layer dense.
28L, d_model=2048, 16H (kv=16), vocab=102400."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="deepseek-moe-16b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408 * 8,              # dense first-layer FFN (DeepSeek: ~d_ff dense)
    vocab_size=102_400,
    layout=(("attn", "moe"),), first_k_dense=1,
    n_experts=64, top_k=6, n_shared_experts=2, d_expert=1408,
    activation="swiglu",
)

SMOKE = ModelConfig(
    name="deepseek-moe-16b-smoke",
    n_layers=3, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    layout=(("attn", "moe"),), first_k_dense=1,
    n_experts=4, top_k=2, n_shared_experts=1, d_expert=64,
    activation="swiglu",
)
