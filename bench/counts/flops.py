"""Model FLOPs of one federated round, from the configuration's shapes.

Counted: the clients' local steps (forward and backward), the enclave's
guiding updates (the same steps on each client's shared sample), and the
forward passes of the eval that closes each segment, spread over its
rounds.  A forward multiply-add counts 2 FLOPs and a training step three
forward passes (the forward and a backward of twice its cost).  Not
counted: recomputation (remat), norms, activations, softmax, the optimizer
and the server's row work, so a change that removes recomputation does
not move the yardstick.
"""
from __future__ import annotations


def mlp3_weights(config: dict) -> int:
    i, h, o = config["input_dim"], config["hidden"], config["n_classes"]
    return i * h + h * h + h * o


def _fl_samples(traffic: dict) -> tuple:
    """(training examples a round, eval examples a round)."""
    N, E = traffic["n_clients"], traffic["local_steps"]
    s = max(1, int(traffic["per_client"] * traffic["sample_frac"]))
    train = N * E * (traffic["batch_size"] + s)
    return train, traffic["n_test"] / traffic["eval_every"]


def mlp3_round(config: dict, traffic: dict) -> float:
    w = mlp3_weights(config)
    train, evals = _fl_samples(traffic)
    return 6.0 * w * train + 2.0 * w * evals


def decoder_layer_weights(config: dict) -> int:
    d, ff, dh = config["d_model"], config["d_ff"], config["head_dim"]
    hq, hk = config["n_heads"] * dh, config["n_kv_heads"] * dh
    return 2 * d * hq + 2 * d * hk + 3 * d * ff


def decoder_matmul_weights(config: dict) -> int:
    """Every weight a token multiplies: the layers and the head (the
    embedding lookup multiplies nothing)."""
    return (config["n_layers"] * decoder_layer_weights(config)
            + config["d_model"] * config["vocab_size"])


def attention_pairs(T: int, window=None) -> int:
    """(query, key) pairs of causal attention over T tokens."""
    w = T if window is None else min(window, T)
    # query i sees min(i + 1, w) keys
    return w * (w + 1) // 2 + (T - w) * w


def decoder_forward(config: dict, seqs: int, T: int, head_rows: int) -> float:
    """Forward FLOPs of ``seqs`` sequences of T tokens whose head runs on
    ``head_rows`` positions of each."""
    L, dh = config["n_layers"], config["head_dim"]
    layers = 2.0 * L * decoder_layer_weights(config) * seqs * T
    attn = 4.0 * L * config["n_heads"] * dh * \
        attention_pairs(T, config.get("window")) * seqs
    head = 2.0 * config["d_model"] * config["vocab_size"] * seqs * head_rows
    return layers + attn + head


def decoder_round(config: dict, traffic: dict) -> float:
    """A local step runs on ``seq_len + 1`` tokens a sequence (the model
    reads the next token too, its loss masks the last position); the eval
    runs ``seq_len`` tokens and the head on the last one."""
    N, E = traffic["n_clients"], traffic["local_steps"]
    S = traffic["seq_len"]
    s = max(1, int(traffic["per_client"] * traffic["sample_frac"]))
    steps = N * E * (traffic["batch_size"] + s)
    train = 3.0 * decoder_forward(config, steps, S + 1, S + 1)
    evals = decoder_forward(config, traffic["n_test"], S, 1) / \
        traffic["eval_every"]
    return train + evals
