"""Serving on the client x model mesh over gloo ranks: the twin of
``tests/test_sharded_step.py::test_serve_step_all_families_on_mesh``.

In 8 ranks on a 4 x 2 mesh (``launch.mesh.spawn_local``: a ``FileStore``
under ``tmp_path``, one torch thread a rank, a time limit on the join),
each rank holds its tiles of the params (``sharding.place_params``) and
serves every family's SMOKE config split over its model group:
``make_prefill``'s last-position logits, one ``decode_step`` from the
prefill's cache (the rank's KV heads and Mamba channels), and
``make_serve_step``'s next token on a zero cache of
``launch.shapes.serve_inputs``'s shapes; jamba's ``make_forward`` loss
too.  Held:

* the logits within the serving bar of the meshless run: 5e-2 of the
  largest meshless logit (bf16, the SMOKE configs' dtype; the split sums
  partial products in another order, as the reference's GSPMD run does);
* the next token the argmax of the rank's own decode logits;
* every result bitwise the same on the two ranks of a model group, and on
  every rank;
* collectives counted (> 0: the split layers' ``all_reduce``s and the
  logits' ``all_gather``), and the models' ``shard()`` sites recording
  the reference's hints on the mesh, and none in the meshless run.

The hint check reads the count's change over each run: ``SHARD_HINTS`` is
a process-wide counter, and under ``-n 6 --dist loadfile`` an xdist
worker runs other files first (``test_torch_s6c_dryrun.py`` traces on a
16-way model axis in the worker itself), so the absolute count is not
this test's.  The launcher (``launch.train.main``) in 4 ranks builds a
2 x 2 mesh and runs the engine on a model axis of 2.
"""
import pytest
import torch

from repro_torch import configs, models, sharding
from repro_torch.launch.mesh import make_host_mesh, spawn_local
from repro_torch.launch.serve import (make_forward, make_prefill,
                                      make_serve_step)
from repro_torch.launch.shapes import InputShape, serve_inputs
from repro_torch.models import frontends

ARCHS = tuple(configs.all_arch_ids())
RANK_TIMEOUT = 240
B, S = 2, 16


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
    """Each arch's prefill logits, decode logits and next tokens (and
    jamba's loss), with the hints the run recorded."""
    out = {}
    hints = sum(sharding.SHARD_HINTS.values())
    for aid in ARCHS:
        cfg = configs.get(aid, smoke=True)
        gen = torch.Generator().manual_seed(0)
        params = models.init(gen, cfg, "cpu")
        for g in params["groups"]:
            if "xgate" in g:
                g["xgate"].fill_(0.5)
        emb = {}
        if cfg.is_enc_dec:
            emb["enc_emb"] = frontends.audio_frames(gen, B, cfg, "cpu")
        elif cfg.has_cross:
            emb["cross_emb"] = frontends.vision_patches(gen, B, cfg, "cpu")
        params = sharding.place_params(params, mesh)
        toks = torch.arange(B * S).reshape(B, S) % cfg.vocab_size
        lg, cache = make_prefill(cfg, mesh)(params, toks, **emb)
        out[aid, "prefill"] = lg
        with sharding.use_mesh(mesh), torch.inference_mode():
            # the prefill's cache is S long: decode position S - 1 again
            dl, _ = models.decode_step(params, cfg, toks[:, -1:], cache,
                                       S - 1)
        out[aid, "decode"] = dl
        if mesh is None:
            cache = models.init_cache(cfg, B, 64, "cpu")
        else:
            specs, _ = serve_inputs(cfg, InputShape("d", "decode", 64, B),
                                    mesh)
            cache = _zeros(specs["cache"])
        if cfg.has_cross or cfg.is_enc_dec:
            cache = None          # a cross layer's cache needs its K/V
        else:
            step = make_serve_step(cfg, mesh, donate_cache=False)
            nt, _ = step(params, torch.ones((B, 1), dtype=torch.int32),
                         cache, 3)
            assert nt.shape == (B, 1) and nt.dtype == torch.int32
            with sharding.use_mesh(mesh), torch.inference_mode():
                want, _ = models.decode_step(
                    params, cfg, torch.ones((B, 1), dtype=torch.int32),
                    _zeros(cache), 3)
            assert torch.equal(nt, torch.argmax(want, -1).to(torch.int32))
            out[aid, "token"] = nt
        if aid == "jamba-v0.1-52b":
            out[aid, "loss"] = make_forward(cfg, mesh)(params, toks)
    out["hinted"] = sum(sharding.SHARD_HINTS.values()) - hints
    return out


def _rank(rank, world):
    mesh = make_host_mesh(4, 2, device="cpu")
    before = sum(sharding.collective_counts().values())
    out = _serve(mesh)
    out["collectives"] = sum(sharding.collective_counts().values()) - before
    out["hints"] = dict(sharding.SHARD_HINTS)
    out["s"] = sharding.model_index(mesh)
    return out


def test_serve_step_all_families_on_mesh(tmp_path):
    want = _serve(None)
    assert want["hinted"] == 0                 # none off-mesh
    ranks = spawn_local(_rank, 8, (), timeout=RANK_TIMEOUT, workdir=tmp_path)
    assert [r["s"] for r in ranks] == [0, 1] * 4
    for r in ranks:
        assert r["collectives"] > 0
        # the models' shard() sites recorded the reference's hints
        assert r["hinted"] > 0 and ((None, None, "model", None) in r["hints"])
        for k, w in want.items():
            if k == "hinted":
                continue
            got = r[k]
            assert got.shape == w.shape, k
            if k[1] in ("prefill", "decode", "loss"):
                err = (got.float() - w.float()).abs().max()
                bar = 5e-2 * w.float().abs().max()
                assert err <= bar, (k, float(err), float(bar))
            # bitwise across the ranks: a model group's and every other
            assert torch.equal(got, ranks[0][k]), k


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
