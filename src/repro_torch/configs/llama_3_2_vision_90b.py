"""llama-3.2-vision-90b [hf:meta-llama/Llama-3.2-11B-Vision (90B scale)] —
VLM decoder: 100L (80 self + 20 gated cross-attn image layers, 1:4
interleave), d_model=8192, 64H (GQA kv=8), d_ff=28672, vocab=128256.
ViT/projector frontend stubbed: cross layers attend to precomputed patch
embeddings (B, 1600, d_model)."""
from ..models.config import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-90b",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28_672, vocab_size=128_256,
    layout=(("attn", "mlp"), ("attn", "mlp"), ("attn", "mlp"),
            ("attn", "mlp"), ("xattn", "mlp")),
    activation="swiglu",
    frontend="vision", n_patches=1600,
    rope_theta=500_000.0,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke",
    n_layers=5, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab_size=512,
    layout=(("attn", "mlp"), ("attn", "mlp"), ("attn", "mlp"),
            ("attn", "mlp"), ("xattn", "mlp")),
    activation="swiglu",
    frontend="vision", n_patches=64,
)
