"""``client_step_rows`` (``kernels/csrc/client_step.cu``: the client
step's epilogue, each update and guide row written once): the least time
of a round's launches over their device time, matched by symbol.

A round runs the kernel on every client's block in Step 2 and every
guide's in Step 3: each reads its c rows of gradients and writes c update
rows, fp32, and reads the shared start params once (from HBM; the other
rows then hit L2), so a round's least time is 2 x (C·D·4 + C·D·4 + k·D·4)
bytes at 3.35 TB/s, k the client blocks, plus C·D·4 a phase read of the
per-client params of the last step where E > 1.  The parent of the kernel
launches none: then nothing is read."""
import re

from bench.counts import kernels

# the kernel's symbol, demangled or mangled
PATTERN = r"client_step_rows_kernel"


def round_bytes(traffic: dict, d: int) -> float:
    N = traffic["n_clients"]
    c = traffic.get("client_chunk") or N
    k = -(-N // c)
    per_client = N * d * 4 if traffic.get("local_steps", 1) > 1 else 0
    return 2 * (2 * N * d * 4 + k * d * 4 + per_client)


def read(trace, ctx):
    rx = re.compile(PATTERN)
    ks = [k for k in trace.kernels if rx.search(k.name)]
    if not ks:
        return None
    least = kernels.least_s(round_bytes(ctx["traffic"], ctx["d"]), 0.0) * \
        trace.rounds
    return 100.0 * least / (sum(k.dur for k in ks) * 1e-6)
