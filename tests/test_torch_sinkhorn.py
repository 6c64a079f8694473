"""The port's log-space Sinkhorn against repconc_tpu.quant.sinkhorn on the
same numpy-seeded distances, and the marginals of tests/test_sinkhorn.py.

Tolerances: log Q within max(1e-5, 8 ulps of 1/eps) absolute plus 1e-6
relative. Every iteration subtracts logsumexps of terms as large as 1/eps
from every entry, so the two libraries' fp32 rounding differs by a few ulps
of 1/eps in all entries: at eps = 0.003 one ulp of 333 is 3e-5, above a
plain 1e-5 bar. Probabilities exp(log Q) within 1e-5 absolute."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repconc_tpu.quant import sinkhorn as jax_sk
from repconc_tpu_torch.quant import sinkhorn

NEAR_TIE = 1e-3  # log Q gap under which two centroids count as tied


def make_distances(seed, M=4, B=128, K=32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, M, 8))
    c = rng.normal(size=(M, K, 8))
    d = ((x[:, :, None, :] - c[None, :, :, :]) ** 2).sum(-1)  # (B, M, K)
    return np.ascontiguousarray(np.transpose(d, (1, 0, 2)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_center_distances_matches_jax(seed):
    d = make_distances(seed)
    want = np.asarray(jax_sk.center_distances(jnp.asarray(d)))
    got = sinkhorn.center_distances(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() <= 1.0


@pytest.mark.parametrize("eps,iters", [(0.05, 100), (0.003, 100), (0.05, 0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_sinkhorn_log_matches_jax(seed, eps, iters):
    centered = np.asarray(jax_sk.center_distances(
        jnp.asarray(make_distances(seed))))
    want = np.asarray(jax_sk.sinkhorn_log(-jnp.asarray(centered), eps, iters))
    got = sinkhorn.sinkhorn_log(-torch.tensor(centered), eps, iters).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    atol = max(1e-5, 8 * float(np.spacing(np.float32(1 / eps))))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
    np.testing.assert_allclose(np.exp(got), np.exp(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("eps", [0.05, 0.003])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sinkhorn_assign_matches_jax_except_near_ties(seed, eps):
    """Codes equal JAX's wherever the sample's two best log Q (JAX's) are
    at least NEAR_TIE apart; near-ties may go either way."""
    d = make_distances(seed, B=256)
    want = np.asarray(jax_sk.sinkhorn_assign(jnp.asarray(d), eps, 100))
    got = sinkhorn.sinkhorn_assign(torch.from_numpy(d), eps, 100).numpy()
    assert got.shape == want.shape == (256, 4)
    logq = np.asarray(jax_sk.sinkhorn_log(
        -jax_sk.center_distances(jnp.asarray(d)), eps, 100))
    top2 = np.sort(logq, axis=-1)[..., -2:]
    tied = (top2[..., 1] - top2[..., 0] < NEAR_TIE).T  # (B, M)
    assert (got[~tied] == want[~tied]).all()
    assert tied.mean() < 0.05


def test_marginals():
    """tests/test_sinkhorn.py:37-47: each sample's row sums to 1, each
    centroid's column to B / K."""
    d = make_distances(0, B=64, K=16)
    centered = sinkhorn.center_distances(torch.from_numpy(d))
    Q = torch.exp(sinkhorn.sinkhorn_log(-centered, epsilon=0.05,
                                        iterations=100)).numpy()
    M, B, K = Q.shape
    np.testing.assert_allclose(Q.sum(-1), np.ones((M, B)), rtol=1e-4)
    np.testing.assert_allclose(Q.sum(1), np.full((M, K), B / K), rtol=1e-2)


def test_small_epsilon_stays_finite():
    """eps = 0.003 (the production value) in fp32: finite, balanced."""
    d = make_distances(3, B=512, K=16)
    codes = sinkhorn.sinkhorn_assign(torch.from_numpy(d), 0.003, 100)
    logq = sinkhorn.sinkhorn_log(
        -sinkhorn.center_distances(torch.from_numpy(d)), 0.003, 100)
    assert torch.isfinite(logq).all()
    counts = torch.stack([torch.bincount(codes[:, m], minlength=16)
                          for m in range(4)])
    assert counts.min() > 0  # every centroid used under the constraint


def test_process_group_not_ported():
    """group= (the marginals across ranks) at world size 1, through a real
    gloo process group joined by the env contract: the one-process
    result, bit for bit. tests/test_torch_parallel.py holds two ranks
    against JAX's axis_name."""
    from test_torch_distributed import world1_mesh

    d = torch.from_numpy(make_distances(0))
    with world1_mesh() as mesh:
        for fn in (lambda g: sinkhorn.center_distances(d, group=g),
                   lambda g: sinkhorn.sinkhorn_log(d, 0.05, 20, group=g),
                   lambda g: sinkhorn.sinkhorn_assign(d, 0.05, 20, group=g)):
            assert torch.equal(fn(mesh.group), fn(None))
