"""falcon-mamba-7b [arXiv:2410.05355] — attention-free Mamba-1.
64 mamba blocks, d_model=4096 (d_inner=8192), ssm_state=16, vocab=65024."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="falcon-mamba-7b",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=65_024,
    layout=(("mamba", "none"),),
    ssm_state=16, ssm_conv=4, ssm_expand=2,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke",
    n_layers=2, d_model=128, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=512,
    layout=(("mamba", "none"),),
    ssm_state=8,
)
