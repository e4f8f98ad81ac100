"""A decoder-only language model with grouped-query attention, plain
PyTorch at float32: the h2o-danube family (Llama and Mistral blocks).

Per layer: ``x += attn(rms1(x))``, ``x += mlp(rms2(x))``; RMSNorm scales
by ``1 + scale`` (eps ``rms_norm_eps``); rotary embedding on the two halves of each
head (theta ``rope_theta``); causal attention within ``window`` keys,
scores over ``sqrt(head_dim)``; a SwiGLU MLP ``(silu(h Wg) * h Wu) Wd``;
a final RMSNorm; the head its own leaf ``head`` (d, vocab), or the
embedding's transpose where the configuration ties them.  The embedding is
scaled by ``sqrt(d_model)`` rounded to the configuration's activation
type, as the model defines it.  The loss is the mean next-token cross
entropy over every position but the last.

Each layer's tensor is a leaf of its own (``wq.<layer>``); ``grads``
runs ``micro`` sequences at a time and adds their gradients.
"""
from __future__ import annotations

import math

import torch

from .precision import Precision

STACKED = ("ln1", "wq", "wk", "wv", "wo", "ln2", "w_gate", "w_up", "w_down")


def _round_to(value: float, dtype: str) -> float:
    t = {"bfloat16": torch.bfloat16, "float32": torch.float32}[dtype]
    return float(torch.tensor(value, dtype=torch.float32).to(t).float())


class Decoder:
    block = 1            # clients a reference step computes at once
    micro = 4            # sequences in one forward and backward

    def __init__(self, config: dict):
        self.L = config["n_layers"]
        self.d = config["d_model"]
        self.H = config["n_heads"]
        self.K = config["n_kv_heads"]
        self.dh = config.get("head_dim") or self.d // self.H
        self.V = config["vocab_size"]
        self.window = config.get("window")
        self.theta = float(config.get("rope_theta", 10000.0))
        self.emb_scale = _round_to(math.sqrt(self.d), config["dtype"])
        self.eps = float(config["rms_norm_eps"])

    def _rms(self, x, scale):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * (1.0 + scale)

    def _rope(self, x, pos):
        half = self.dh // 2
        freq = self.theta ** (-torch.arange(0, half, dtype=torch.float32,
                                            device=x.device) / half)
        ang = pos[:, None].float() * freq
        sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _attention(self, q, k, v):
        """q (b, S, H, dh), k/v (b, S, K, dh) -> (b, S, H*dh)."""
        b, S = q.shape[:2]
        g = self.H // self.K
        qg = q.reshape(b, S, self.K, g, self.dh)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, k) / math.sqrt(self.dh)
        i = torch.arange(S, device=q.device)
        mask = i[None, :] <= i[:, None]
        if self.window is not None:
            mask &= i[None, :] > i[:, None] - self.window
        s = s.masked_fill(~mask, float("-inf"))
        o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, -1), v)
        return o.reshape(b, S, self.H * self.dh)

    def hidden(self, p, tok, prec: Precision):
        """p: leaves by reference name (``wq.<layer>`` ...); tok (b, S)."""
        b, S = tok.shape
        pos = torch.arange(S, device=tok.device)
        x = p["embed"][tok] * self.emb_scale
        for li in range(self.L):
            def w(name):
                return p[f"{name}.{li}"]
            h = self._rms(x, w("ln1"))
            q = prec.mm(h, w("wq")).reshape(b, S, self.H, self.dh)
            k = prec.mm(h, w("wk")).reshape(b, S, self.K, self.dh)
            v = prec.mm(h, w("wv")).reshape(b, S, self.K, self.dh)
            o = self._attention(self._rope(q, pos), self._rope(k, pos), v)
            x = x + prec.mm(o, w("wo"))
            h = self._rms(x, w("ln2"))
            f = torch.nn.functional.silu(prec.mm(h, w("w_gate"))) * \
                prec.mm(h, w("w_up"))
            x = x + prec.mm(f, w("w_down"))
        return self._rms(x, p["final_norm"])

    def nll_sum(self, p, tok, prec: Precision):
        """Summed cross entropy of tokens 1.. given their prefixes."""
        h = self.hidden(p, tok, prec)[:, :-1]
        w = p["head"][:, :self.V] if "head" in p else p["embed"][:self.V].t()
        lg = prec.mm(h, w)
        return torch.nn.functional.cross_entropy(
            lg.reshape(-1, self.V), tok[:, 1:].reshape(-1), reduction="sum")

    def grads(self, p32, xs, ys, l2: float, prec: Precision):
        """Each client's gradient of its mean loss (plus ``0.5 * l2 *
        sum |p|^2``): p32 the float32 leaves (made leaves of autograd
        here), xs (c, m, S) token ids, ys (c, m) the next tokens ->
        {leaf: (c, ...)}."""
        for v in p32.values():
            v.requires_grad_(True)
        out = {k: [] for k in p32}
        for i in range(xs.shape[0]):
            tok = torch.cat([xs[i].long(), ys[i].long()[:, None]], 1)
            n_pred = tok.shape[0] * (tok.shape[1] - 1)
            with torch.enable_grad():
                for s0 in range(0, tok.shape[0], self.micro):
                    loss = self.nll_sum(p32, tok[s0:s0 + self.micro],
                                        prec) / n_pred
                    loss.backward()
            for k, v in p32.items():
                g = v.grad
                v.grad = None
                out[k].append(g if not l2 else g + l2 * v.detach())
        return {k: torch.stack(v) if len(v) > 1 else v[0].unsqueeze(0)
                for k, v in out.items()}

