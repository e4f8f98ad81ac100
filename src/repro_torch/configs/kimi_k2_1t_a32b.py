"""kimi-k2-1t-a32b [arXiv:2501.kimi2] — trillion-parameter MoE:
384 routed experts top-8, 61L, d_model=7168, 64H (GQA kv=8),
expert hidden 2048, vocab=163840, first layer dense (paper-table entry)."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="kimi-k2-1t-a32b",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048 * 8,              # dense first-layer FFN
    vocab_size=163_840,
    layout=(("attn", "moe"),), first_k_dense=1,
    n_experts=384, top_k=8, n_shared_experts=1, d_expert=2048,
    activation="swiglu",
    capacity_factor=1.25,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke",
    n_layers=3, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab_size=512,
    layout=(("attn", "moe"),), first_k_dense=1,
    n_experts=4, top_k=2, n_shared_experts=1, d_expert=64,
    activation="swiglu",
)
