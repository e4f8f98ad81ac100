"""Model configuration of the port's transformer zoo.

The counterpart of ``repro/models/config.py``: one ``ModelConfig``
describes every architecture family of the zoo (dense decoders with
MHA/GQA/MQA and an optional sliding window, fine-grained MoE, Mamba-1
SSMs, hybrid stacks, encoder-decoder and VLM decoders), with the same
fields, defaults, checks and properties.  Layers repeat a ``layout``
group of ``(mixer, ffn)`` pairs; ``n_layers`` must be ``first_k_dense +
n_groups * len(layout)``.

``dtype`` and ``param_dtype`` stay strings, as in the reference;
:func:`torch_dtype` maps them to torch dtypes.  ``remat`` checkpoints
each layout group when a backward pass will run (``models/model.py``);
``scan_layers`` is kept for parity and has no effect in the port: it is
a compile concern of the JAX package.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

Mixer = str
Ffn = str
LayoutEntry = Tuple[Mixer, Ffn]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype string (or a torch dtype) -> the torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default: d_model // n_heads
    layout: Tuple[LayoutEntry, ...] = (("attn", "mlp"),)
    first_k_dense: int = 0                  # leading unstacked dense-MLP attn layers
    activation: str = "swiglu"              # swiglu | geglu | gelu | relu
    norm: str = "rmsnorm"                   # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    window: Optional[int] = None            # sliding-window size for swa mixers
    logit_softcap: Optional[float] = None

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: Optional[int] = None          # fine-grained expert hidden dim (defaults d_ff)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # --- SSM (Mamba-1) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: Optional[int] = None           # default ceil(d_model / 16)

    # --- encoder (enc-dec archs; None => decoder-only) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500                     # precomputed frame-embedding length

    # --- modality frontend stub ---
    frontend: Optional[str] = None          # None | "audio" | "vision"
    n_patches: int = 1600                   # VLM patch embeddings per example

    # --- numerics / implementation ---
    dtype: str = "bfloat16"                 # activation / param compute dtype
    param_dtype: str = "bfloat16"
    attn_chunk: int = 1024                  # q-chunk for blockwise attention
    attn_direct_max: int = 2048             # direct attention for seq <= this
    loss_chunk: int = 2048                  # token chunk of the chunked xent
    tie_embeddings: bool = True
    remat: bool = True                      # checkpoint each group under grad
    use_kernels: bool = False               # route hot ops through the CUDA kernels
    scan_layers: bool = True                # no effect in the port

    # ------------------------------------------------------------------
    def __post_init__(self):
        hd = self.head_dim or (self.d_model // max(self.n_heads, 1))
        object.__setattr__(self, "head_dim", hd)
        if self.dt_rank is None:
            object.__setattr__(self, "dt_rank",
                               max(1, math.ceil(self.d_model / 16)))
        if self.d_expert is None:
            object.__setattr__(self, "d_expert", self.d_ff)
        body = self.n_layers - self.first_k_dense
        if self.layout and body % len(self.layout) != 0:
            raise ValueError(
                f"{self.name}: n_layers-first_k_dense={body} not divisible by "
                f"layout length {len(self.layout)}")
        if any(m == "swa" for m, _ in self.layout) and self.window is None:
            raise ValueError(f"{self.name}: swa mixer requires window")
        if any(f == "moe" for _, f in self.layout) and self.n_experts <= 0:
            raise ValueError(f"{self.name}: moe layout requires n_experts > 0")

    # ------------------------------------------------------------------
    @property
    def n_groups(self) -> int:
        return (self.n_layers - self.first_k_dense) // len(self.layout)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_enc_dec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def has_cross(self) -> bool:
        return any(m in ("xattn", "attn_x") for m, _ in self.layout)

    @property
    def cross_len(self) -> int:
        """Length of the cross-attended embedding sequence."""
        return self.enc_seq if self.is_enc_dec else self.n_patches

    @property
    def attn_free(self) -> bool:
        return all(m == "mamba" for m, _ in self.layout) and \
            self.first_k_dense == 0

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 (the reference pads
        so the vocab dim shards evenly); pad logits are masked out in the
        loss and at decode."""
        return -(-self.vocab_size // 256) * 256

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can serve very long contexts: attention-free,
        sliding-window, or hybrid stacks whose full-attention layers are at
        most a quarter of the layers."""
        def is_full_attn(m):
            return (m in ("attn", "attn_x")) and self.window is None

        full = sum(is_full_attn(m) for m, _ in self.layout)
        mamba = sum(m == "mamba" for m, _ in self.layout)
        if full == 0 and self.first_k_dense == 0:
            return True
        n_full = full * max(self.n_groups, 1) + self.first_k_dense
        return mamba > 0 and n_full / max(self.n_layers, 1) <= 0.25

    # ------------------------------------------------------------------
    def _meta_leaves(self):
        """(path, shape) of every parameter, from the port's ``init`` on
        the meta device (no memory, no random draws)."""
        from . import model as _model  # lazy; avoids the import cycle
        params = _model.init(None, self, device="meta")
        out = []

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (str(k),))
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, path + (str(i),))
            else:
                out.append(("/".join(path), tuple(node.shape)))
        walk(params, ())
        return out

    def param_count(self) -> int:
        """Exact parameter count of the constructed model (see model.init)."""
        return sum(math.prod(s) for _, s in self._meta_leaves())

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared experts only)."""
        total = 0
        for path, shape in self._meta_leaves():
            n = math.prod(shape)
            if "routed" in path and self.n_experts > 0:
                n = n * self.top_k // self.n_experts
            total += n
        return total
