"""Decoder-only language models of the zoo (dense GQA blocks), federated
through ``repro_torch.fl.zoo``: next-token prediction on Zipf-like token
streams, one example a sequence of ``seq_len + 1`` tokens.  Each client's
sequences are drawn on their own (the silos' own text: no shared split).
The head is its own leaf unless the configuration ties it to the
embedding.
"""
from __future__ import annotations

import math

import torch

from bench.counts import flops
from bench.harness.seeds import generator
from bench.reference.decoder import STACKED, Decoder

# the program's flat param path (after its "<position>:" prefix) of each
# stacked leaf of the benchmark
_PATHS = {"embed": "embed", "final_norm": "final_norm/scale",
          "ln1": "groups/0/ln1/scale", "wq": "groups/0/attn/wq",
          "wk": "groups/0/attn/wk", "wv": "groups/0/attn/wv",
          "wo": "groups/0/attn/wo", "ln2": "groups/0/ln2/scale",
          "w_gate": "groups/0/mlp/w_gate", "w_up": "groups/0/mlp/w_up",
          "w_down": "groups/0/mlp/w_down", "head": "lm_head"}

_NORMS = ("final_norm", "ln1", "ln2")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# (config overrides, traffic overrides) of the CPU tests' tiny cells
TINY = ({"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 512, "window": 16},
        {"n_clients": 4, "f": 1, "per_client": 8, "seq_len": 24,
         "batch_size": 4, "n_test": 4})


def model_config(config: dict):
    from repro_torch.models import ModelConfig
    mixer = "swa" if config.get("window") else "attn"
    return ModelConfig(
        name=config["name"], n_layers=config["n_layers"],
        d_model=config["d_model"], n_heads=config["n_heads"],
        n_kv_heads=config["n_kv_heads"], head_dim=config["head_dim"],
        d_ff=config["d_ff"], vocab_size=config["vocab_size"],
        layout=((mixer, "mlp"),), window=config.get("window"),
        activation=config["activation"], norm=config["norm"],
        rope_theta=config["rope_theta"], dtype=config["dtype"],
        param_dtype=config["param_dtype"],
        tie_embeddings=config["tie_embeddings"], remat=config["remat"])


def program_model(config: dict, traffic: dict):
    from repro_torch.fl.zoo import zoo_model
    return zoo_model(model_config(config), seq_len=traffic["seq_len"])


def padded_vocab(config: dict) -> int:
    return -(-config["vocab_size"] // 256) * 256


def param_shapes(config: dict) -> dict:
    L, d, ff = config["n_layers"], config["d_model"], config["d_ff"]
    hq = config["n_heads"] * config["head_dim"]
    hk = config["n_kv_heads"] * config["head_dim"]
    return {"embed": (padded_vocab(config), d), "final_norm": (d,),
            "ln1": (L, d), "wq": (L, d, hq), "wk": (L, d, hk),
            "wv": (L, d, hk), "wo": (L, hq, d), "ln2": (L, d),
            "w_gate": (L, d, ff), "w_up": (L, d, ff), "w_down": (L, ff, d),
            **({} if config["tie_embeddings"] else
               {"head": (d, padded_vocab(config))})}


def make_params(config: dict, seed: int, device) -> dict:
    """Stacked leaves in the served type, one draw each: N(0, 1/fan_in)
    matrices, zero norm scales (RMSNorm scales by 1 + scale)."""
    g = generator(seed, "params", device)
    dt = _DTYPES[config["param_dtype"]]
    out = {}
    for k, shape in param_shapes(config).items():
        if k in _NORMS:
            out[k] = torch.zeros(shape, dtype=dt, device=device)
            continue
        fan_in = shape[-1] if k == "embed" else shape[-2]
        t = torch.randn(shape, generator=g, device=device)
        out[k] = t.mul_(1.0 / math.sqrt(fan_in)).to(dt)
        del t
    return out


def _program_keys(model) -> dict:
    """The benchmark's stacked name of each program key."""
    by_path = {v: k for k, v in _PATHS.items()}
    out = {}
    for key in model.like:
        path = key.split(":", 1)[1]
        if path not in by_path:
            raise KeyError(f"program param {key!r} has no counterpart in "
                           f"the benchmark's decoder family")
        out[key] = by_path[path]
    return out


def to_program(params: dict, model) -> dict:
    out = {}
    for key, name in _program_keys(model).items():
        t = params[name]
        if tuple(t.shape) != tuple(model.like[key].shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} but the "
                             f"program expects {tuple(model.like[key].shape)}")
        out[key] = t
    return out


def leaves(params: dict) -> dict:
    """The reference's leaves: each layer's tensor a leaf (views)."""
    out = {k: params[k] for k in ("embed", "final_norm", "head")
           if k in params}
    for k in STACKED:
        for i in range(params[k].shape[0]):
            out[f"{k}.{i}"] = params[k][i]
    return out


def from_program(params: dict, model) -> dict:
    names = _program_keys(model)
    return leaves({names[k]: v for k, v in params.items()})


def make_tokens(g, n_seqs: int, seq_len: int, vocab: int,
                zipf_a: float = 1.2) -> torch.Tensor:
    """Zipf-like ids with a per-sequence topic shift: (n_seqs, seq_len)."""
    u = torch.rand((n_seqs, seq_len), generator=g, device=g.device)
    u = u * (1.0 - 1e-6) + 1e-6
    shift = torch.randint(0, vocab, (n_seqs, 1), generator=g, device=g.device)
    ranks = torch.floor(torch.exp(torch.log(u) / (-zipf_a + 1e-9))) % vocab
    return (ranks.to(torch.int64) + shift) % vocab


def make_data(config: dict, traffic: dict, seed: int, device) -> dict:
    """Clients' sequences drawn independently (the silos' own text), plus
    a test split; x the first ``seq_len`` tokens, y the next."""
    g = generator(seed, "data", device)
    N, n, S = traffic["n_clients"], traffic["per_client"], traffic["seq_len"]
    tok = make_tokens(g, N * n + traffic["n_test"], S + 1,
                      config["vocab_size"], config["data"]["zipf_a"])
    tr = tok[:N * n].reshape(N, n, S + 1)
    te = tok[N * n:]
    return {"x": tr[..., :S], "y": tr[..., S], "test_x": te[:, :S],
            "test_y": te[:, S], "n_classes": config["vocab_size"]}


def reference(config: dict):
    return Decoder(config)


def model_flops(config: dict, traffic: dict) -> float:
    return flops.decoder_round(config, traffic)
