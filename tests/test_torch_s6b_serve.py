"""Serving on the client x model mesh over gloo ranks: the twin of
``tests/test_sharded_step.py::test_serve_step_all_families_on_mesh``.

In 8 ranks on a 4 x 2 mesh (``launch.mesh.spawn_local``: a ``FileStore``
under ``tmp_path``, one torch thread a rank, a time limit on the join),
with the params whole on every rank, ``make_serve_step(cfg, mesh)`` gives the
meshless next tokens for falcon-mamba-7b, jamba-v0.1-52b and
whisper-medium (SMOKE, a zero cache of ``launch.shapes.serve_inputs``'s
shapes), and ``make_prefill``/``make_forward`` the meshless logits and
loss for jamba, bit for bit, the models' ``shard()`` sites recording
their hints on the mesh (and none off it), and no collective issued.
The launcher (``launch.train.main``) in 4
ranks builds a 2 x 2 mesh and runs the engine on a model axis of 2.
"""
import pytest
import torch

from repro_torch import configs, models, sharding
from repro_torch.launch.mesh import make_host_mesh, spawn_local
from repro_torch.launch.serve import (make_forward, make_prefill,
                                      make_serve_step)
from repro_torch.launch.shapes import InputShape, serve_inputs

ARCHS = ("falcon-mamba-7b", "jamba-v0.1-52b", "whisper-medium")
RANK_TIMEOUT = 150


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_zeros(v) for v in tree)
    return torch.zeros(tree.shape, dtype=tree.dtype)


def _serve(mesh):
    """Next tokens of each arch (and jamba's prefill logits and loss)."""
    out = {}
    for aid in ARCHS:
        cfg = configs.get(aid, smoke=True)
        params = models.init(torch.Generator().manual_seed(0), cfg, "cpu")
        if mesh is None:
            cache = models.init_cache(cfg, 8, 64, "cpu")
        else:
            specs, _ = serve_inputs(cfg, InputShape("d", "decode", 64, 8),
                                    mesh)
            cache = _zeros(specs["cache"])
        step = make_serve_step(cfg, mesh, donate_cache=False)
        nt, _ = step(params, torch.ones((8, 1), dtype=torch.int32), cache, 3)
        assert nt.shape == (8, 1)
        out[aid] = nt
        if aid == "jamba-v0.1-52b":
            toks = torch.arange(2 * 16).reshape(2, 16) % cfg.vocab_size
            out["prefill"] = make_prefill(cfg, mesh)(params, toks)[0]
            out["loss"] = make_forward(cfg, mesh)(params, toks)
    return out


def _rank(rank, world):
    mesh = make_host_mesh(4, 2, device="cpu")
    before = sum(sharding.collective_counts().values())
    hints = sum(sharding.SHARD_HINTS.values())
    out = _serve(mesh)
    out["collectives"] = sum(sharding.collective_counts().values()) - before
    out["hints"] = dict(sharding.SHARD_HINTS)
    out["hinted"] = sum(sharding.SHARD_HINTS.values()) - hints
    return out


def test_serve_step_all_families_on_mesh(tmp_path):
    want = _serve(None)
    ranks = spawn_local(_rank, 8, (), timeout=RANK_TIMEOUT, workdir=tmp_path)
    for r in ranks:
        assert r["collectives"] == 0       # whole params: nothing to gather
        # the models' shard() sites recorded the reference's hints
        assert r["hinted"] > 0 and ((None, None, "model", None) in r["hints"])
        for k in want:
            assert torch.equal(r[k], want[k]), k
    assert sum(sharding.SHARD_HINTS.values()) == 0     # none off-mesh


def _cli_rank(rank, world):
    import contextlib
    import io
    from repro_torch.launch.train import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["--arch", "gemma-2b", "--rounds", "2", "--seq", "16",
              "--batch", "4", "--eval-every", "1", "--device", "cpu"])
    return buf.getvalue()


def test_train_cli_on_a_client_x_model_mesh(tmp_path):
    """The launcher in 4 ranks builds the 2 x 2 mesh (2 clients, model
    axis 2) and every rank prints the same rounds."""
    outs = spawn_local(_cli_rank, 4, (), timeout=RANK_TIMEOUT,
                       workdir=tmp_path)
    assert "on mesh {'data': 2, 'model': 2} (2 clients)" in outs[0]
    assert "round   2 acc=" in outs[0]
    assert len(set(outs)) == 1
