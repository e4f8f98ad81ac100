"""The paper's 3-NN (784-200-200-10) on MNIST-like class-template data.

What the harness needs of a family (``bench/harness/spec.FAMILY_API``):
the program's model, the shapes and the benchmark-made weights, the map
between the program's param names and the reference's leaves, the
federated data, the plain reference, the model FLOPs of a round, and
``TINY``, the cut the CPU tests run its cells at.
"""
from __future__ import annotations

import torch

from bench.counts import flops
from bench.harness.seeds import generator
from bench.reference.mlp3 import LEAVES, MLP3

# (config overrides, traffic overrides) of the CPU tests' tiny cells
TINY = ({"hidden": 16},
        {"n_clients": 16, "f": 3, "per_client": 10, "batch_size": 4,
         "client_chunk": 4, "graph": False, "eval_every": 2, "n_test": 32})


def program_model(config: dict, traffic: dict):
    from repro_torch.fl.small_models import mlp3
    return mlp3(input_dim=config["input_dim"], n_classes=config["n_classes"],
                hidden=config["hidden"])


def param_shapes(config: dict) -> dict:
    i, h, o = config["input_dim"], config["hidden"], config["n_classes"]
    return {"w1": (i, h), "b1": (h,), "w2": (h, h), "b2": (h,),
            "w3": (h, o), "b3": (o,)}


def make_params(config: dict, seed: int, device) -> dict:
    """Glorot-normal weights from one draw, zero biases, float32."""
    shapes = param_shapes(config)
    ws = [k for k in LEAVES if k.startswith("w")]
    sizes = [shapes[k][0] * shapes[k][1] for k in ws]
    flat = torch.randn(sum(sizes), generator=generator(seed, "params", device),
                       device=device)
    out, off = {}, 0
    for k, n in zip(ws, sizes):
        fi, fo = shapes[k]
        out[k] = flat[off:off + n].view(fi, fo) * (2.0 / (fi + fo)) ** 0.5
        off += n
    for k in LEAVES:
        if k.startswith("b"):
            out[k] = torch.zeros(shapes[k], device=device)
    return {k: out[k] for k in LEAVES}


def to_program(params: dict, model) -> dict:
    return dict(params)


def leaves(params: dict) -> dict:
    """The reference's leaves of params (here the same tensors)."""
    return dict(params)


def from_program(params: dict, model) -> dict:
    return dict(params)


def make_data(config: dict, traffic: dict, seed: int, device) -> dict:
    """Class templates plus noise (x = T[y] + noise * N(0, I)), the
    templates drawn from the seed and shared by train and test; the
    training rows sorted by class and cut into equal client shards
    (Sec. IV-A's sorted-shard non-IID split)."""
    g = generator(seed, "data", device)
    N, n = traffic["n_clients"], traffic["per_client"]
    dim, C = config["input_dim"], config["n_classes"]
    data = config["data"]
    total = N * n + traffic["n_test"]
    templates = torch.randn((C, dim), generator=g, device=device) * \
        data["template_scale"]
    y = torch.randint(0, C, (total,), generator=g, device=device)
    x = templates[y] + data["noise"] * torch.randn((total, dim), generator=g,
                                                   device=device)
    ytr = y[:N * n]
    order = torch.sort(ytr, stable=True).indices
    return {"x": x[:N * n][order].reshape(N, n, dim),
            "y": ytr[order].reshape(N, n),
            "test_x": x[N * n:], "test_y": y[N * n:], "n_classes": C}


def reference(config: dict):
    return MLP3(config)


def model_flops(config: dict, traffic: dict) -> float:
    return flops.mlp3_round(config, traffic)
