"""The int8 uplink's plain reference (``bench/reference/int8.py``)
against the port's codec (``repro_torch.fl.compression``) at tiny
widths: the same codes and scales for the same rows, ties at .5 and
all-zero blocks among them, and the same residuals over three rounds of
error feedback; and the harness's carry of the clients' residuals from
one ``run_training`` call to the next."""
import dataclasses

import pytest
import torch

from bench.harness import fl
from bench.reference import int8
from bench.tests._tiny import tiny

WIDTHS = (1, 127, 128, 300, 1000)


def _codec():
    from repro_torch.fl.compression import get_codec
    return get_codec("int8")


def _rows(d, seed, n=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g) * torch.logspace(-3, 3, n)[:, None]
    x[1, :min(d, 128)] = 0.0                     # an all-zero block
    return x


@pytest.mark.parametrize("d", WIDTHS)
def test_same_codes_and_scales(d):
    x = _rows(d, d)
    enc = _codec().encode(x)
    q, s = int8.encode(x)
    assert torch.equal(q, enc["q"]) and torch.equal(s, enc["scale"])
    assert torch.equal(int8.decode(q, s), _codec().decode(enc))
    assert not q[1, :min(d, 128)].any() and s[1, 0] == 0


def test_ties_round_half_to_even():
    # absmax 127 gives scale 1: every value is its own quotient
    x = torch.tensor([[127.0, 2.5, 3.5, -2.5, -3.5, 0.5, -0.5, 1.5, 126.5]])
    q, s = int8.encode(x)
    assert s.tolist() == [[1.0]]
    assert q.tolist() == [[127, 2, 4, -2, -4, 0, 0, 2, 126]]
    assert torch.equal(q, _codec().encode(x)["q"])


def test_codes_are_clipped_and_blocks_cut_at_128():
    x = torch.zeros((1, 256))
    x[0, 0], x[0, 1], x[0, 128] = 254.0, -254.0, 1e-20
    q, s = int8.encode(x)
    assert q[0, :2].tolist() == [127, -127] and q[0, 128] == 127
    assert torch.equal(s, _codec().encode(x)["scale"])


@pytest.mark.parametrize("d", (300, 1000))
def test_residuals_equal_over_three_rounds(d):
    from repro_torch.fl.compression import encode_with_feedback
    r_ref = torch.zeros((4, d))
    r_prog = torch.zeros((4, d))
    for t in range(3):
        u = _rows(d, 100 * d + t, n=4)
        dec_ref, r_ref = int8.feedback(u, r_ref)
        _, dec_prog, r_prog = encode_with_feedback(_codec(), u, r_prog)
        assert torch.equal(dec_ref, dec_prog)
        assert torch.equal(r_ref, r_prog)
    assert r_ref.abs().max() > 0


@pytest.mark.parametrize("seed", [11, 12])
def test_the_residuals_carry_from_call_to_call(seed):
    """The followed rounds are one ``run_training`` call each, and the
    harness hands each call the residuals the calls before left (on the
    card from the engine's captured carry, here through the eager round's
    in-place update).  The program's residuals change from call to call,
    and after the last they are the reference's, which carries them
    through the same rounds in one process."""
    cell = tiny("mlp3-xdevice-int8")
    cell = dataclasses.replace(cell, checks=dict(cell.checks,
                                                 warm_segments=0))
    run = fl.FLCell(cell, seed, "cpu")
    seen, call = [], run.run

    def keeping(params, lrs):
        out = call(params, lrs)
        seen.append(run.resid.clone())
        return out
    run.run = keeping
    run.setup()
    assert len(seen) == run.k
    for r, (a, b) in enumerate(zip(seen, seen[1:]), start=2):
        assert not torch.equal(a, b), (
            f"call {r} left the clients' residuals as call {r - 1} did: "
            f"the harness no longer carries them across run_training calls")
    states = run.program_outputs()["states"]
    run.release()
    ref = run.reference(states)["resid"]
    gap = float(torch.linalg.vector_norm(seen[-1] - ref)
                / torch.linalg.vector_norm(ref))
    assert gap <= 1e-3, (
        f"after {run.k} calls the program's residuals are {gap:.3g} of the "
        f"reference's norm away from them: error feedback does not carry "
        f"across run_training calls as it does through one run")
