"""The port's kernel layer against the JAX reference, on the CPU.

The CUDA kernels run only on the card (chip_smoke.py holds them against
their plain versions there).  Here the plain versions, which the kernel
ops use for CPU tensors, are held against the reference's oracles
(``kernels/ref.py``) and its Pallas kernels in interpret mode, on the
same numpy inputs; and the CUDA wrappers' input checks and the build's
error path are exercised without a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.diversefl import DiverseFLConfig as JaxDFLConfig
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core.diversefl import DiverseFLConfig
from repro_torch.kernels import _build, ops
from repro_torch.kernels.client_step import client_step_rows_plain
from repro_torch.kernels.dequant_fold import dequant_fold_update_plain
from repro_torch.kernels.masked_agg import masked_agg_cuda, masked_agg_plain
from repro_torch.kernels.similarity import similarity_cuda, similarity_plain

RTOL, ATOL = 1e-5, 1e-6
# (N, D): the slice's clients at a small D, a ragged D (not a multiple of
# 4 or of the Pallas chunk), a single client, and the slice's full shape
SHAPES = [(5, 300), (7, 1001), (1, 257), (23, 7850)]


def _updates(n, d, seed=0):
    """Updates and guides whose criterion outcomes vary by row: aligned,
    sign-flipped, too long and too short updates."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, d)).astype(np.float32)
    factor = np.resize(np.array([1.0, -1.0, 3.0, 0.2, 1.3], np.float32), n)
    u = (g * factor[:, None]
         + 0.3 * rng.normal(size=(n, d))).astype(np.float32)
    return u, g


@pytest.mark.parametrize("shape", SHAPES)
def test_similarity_plain_matches_reference(shape):
    u, g = _updates(*shape)
    got = similarity_plain(torch.from_numpy(u), torch.from_numpy(g)).numpy()
    for want in (jax_ref.similarity_ref(jnp.asarray(u), jnp.asarray(g)),
                 jax_ops.similarity_stats(jnp.asarray(u), jnp.asarray(g))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mask_kind", ["random", "empty", "full", "float"])
@pytest.mark.parametrize("shape", SHAPES)
def test_masked_agg_plain_matches_reference(shape, mask_kind):
    n, d = shape
    u, _ = _updates(n, d, seed=1)
    rng = np.random.default_rng(2)
    mask = {"random": rng.random(n) > 0.4, "empty": np.zeros(n, bool),
            "full": np.ones(n, bool),
            "float": (rng.random(n) > 0.4).astype(np.float32)}[mask_kind]
    got = masked_agg_plain(torch.from_numpy(u), torch.from_numpy(mask)).numpy()
    for want in (jax_ref.masked_agg_ref(jnp.asarray(u), jnp.asarray(mask)),
                 jax_ops.masked_aggregate(jnp.asarray(u), jnp.asarray(mask))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    if mask_kind == "empty":
        assert not got.any(), "an empty mask must give exactly the zero update"


@pytest.mark.parametrize("shape", SHAPES)
def test_diversefl_step45_matches_reference(shape):
    u, g = _updates(*shape, seed=3)
    delta, mask, stats = ops.diversefl_step45(
        torch.from_numpy(u), torch.from_numpy(g), DiverseFLConfig())
    jd, jm, jstats = jax_ops.diversefl_step45(jnp.asarray(u), jnp.asarray(g),
                                              JaxDFLConfig())
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_allclose(delta.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(stats, jstats):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


def test_ops_send_cpu_tensors_to_the_plain_versions():
    u, g = _updates(6, 130)
    ut, gt = torch.from_numpy(u), torch.from_numpy(g)
    mask = torch.tensor([True, False, True, True, False, True])
    ops.reset_launch_counts()
    assert torch.equal(ops.similarity_stats(ut, gt), similarity_plain(ut, gt))
    assert torch.equal(ops.masked_aggregate(ut, mask),
                       masked_agg_plain(ut, mask))
    q = torch.from_numpy(np.resize(np.arange(-127, 128, dtype=np.int8),
                                   (6, 130)))
    scale, w, acc = torch.rand(6, 2), mask.float(), ut[0]
    assert torch.equal(ops.dequant_fold_update(q, scale, w, acc, 128),
                       dequant_fold_update_plain(q, scale, w, acc, 128))
    th = [ut[0].unsqueeze(0).expand(6, 130)]
    assert torch.equal(
        ops.client_step_rows(torch.empty(6, 130), [gt], th, th, 0.1, 5e-4),
        client_step_rows_plain(torch.empty(6, 130), [gt], th, th, 0.1, 5e-4))
    assert ops.launch_counts() == {"similarity_stats": 0,
                                   "masked_aggregate": 0,
                                   "masked_agg_update": 0,
                                   "robust_aggregate": 0,
                                   "dequant_fold_update": 0,
                                   "flash_attention": 0,
                                   "mamba_scan": 0,
                                   "client_step_rows": 0}


def test_ops_reject_devices_without_a_kernel_or_plain_route():
    z = torch.empty((2, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.similarity_stats(z, z)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.masked_aggregate(z, torch.ones(2, dtype=torch.bool, device="meta"))


def test_cuda_wrappers_refuse_cpu_tensors_before_building():
    z = torch.zeros((3, 16))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        similarity_cuda(z, z)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        masked_agg_cuda(z, torch.ones(3, dtype=torch.bool))
    assert similarity_cuda.launches == 0 and masked_agg_cuda.launches == 0


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def _fake_nvcc(tmp_path, body):
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(0o755)
    return str(script)


def test_build_runs_one_nvcc_per_source_and_reports_failures(monkeypatch,
                                                              tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_BUILT", {})
    # a failing compiler: the error carries its standard error
    monkeypatch.setattr(_build, "nvcc_path", lambda: _fake_nvcc(
        tmp_path, 'echo "error: bad kernel" >&2\nexit 2\n'))
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build_all()
    # a working compiler: one library per source, named by content hash
    monkeypatch.setattr(_build, "nvcc_path", lambda: _fake_nvcc(
        tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                  'echo "ptxas info : Used 32 registers" >&2\n'
                  'touch "$2"\n'))
    built = _build.build_all()
    assert set(built) == set(_build.SOURCES)
    for name, b in built.items():
        assert b.path == _build._target(name) and b.path.exists()
        assert "registers" in b.log
    # built libraries are reused: a broken compiler is never called again
    monkeypatch.setattr(_build, "_BUILT", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: _fake_nvcc(
        tmp_path, "exit 3\n"))
    assert set(_build.build_all()) == set(_build.SOURCES)
