"""jamba-v0.1-52b [arXiv:2403.19887] — hybrid Mamba+attention 1:7
interleave with MoE every other layer (16 experts top-2).
32L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=65536, ssm_state=16."""
from ..models.config import ModelConfig

_GROUP = (("mamba", "mlp"), ("mamba", "moe"), ("mamba", "mlp"),
          ("mamba", "moe"), ("attn", "mlp"), ("mamba", "moe"),
          ("mamba", "mlp"), ("mamba", "moe"))

FULL = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14_336, vocab_size=65_536,
    layout=_GROUP,
    n_experts=16, top_k=2, n_shared_experts=0, d_expert=14_336,
    ssm_state=16, ssm_conv=4, ssm_expand=2,
    activation="swiglu",
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    n_layers=8, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    layout=_GROUP,
    n_experts=4, top_k=2, n_shared_experts=0, d_expert=256,
    ssm_state=8,
    activation="swiglu",
)
