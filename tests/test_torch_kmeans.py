"""The port's k-means (repconc_tpu_torch/index/kmeans.py) against
repconc_tpu/index/kmeans.py on numpy-seeded inputs, on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repconc_tpu.index import kmeans as jax_kmeans
from repconc_tpu.index.opq import subsample_for_training as jax_subsample
from repconc_tpu_torch.index import kmeans


def _clustered(seed, N=600, d=16, centers=8, spread=0.3):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, d)).astype(np.float32) * 3
    x = c[rng.integers(0, centers, N)] + rng.normal(size=(N, d)).astype(
        np.float32) * spread
    return x.astype(np.float32)


def _sqdist(x, c):
    return ((x[:, None, :].astype(np.float64) - c[None].astype(np.float64))
            ** 2).sum(-1)


@pytest.mark.parametrize("N,d,K", [(1, 4, 3), (500, 16, 32), (1000, 64, 7)])
def test_assign_matches_jax(N, d, K):
    """Equal ids except fp32 near-ties (distances within 1e-4 in float64)."""
    rng = np.random.default_rng(N + d + K)
    x = rng.normal(size=(N, d)).astype(np.float32)
    c = rng.normal(size=(K, d)).astype(np.float32)
    want = np.asarray(jax_kmeans.assign(jnp.asarray(x), jnp.asarray(c)))
    got = kmeans.assign(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    diff = got != want
    dist = _sqdist(x, c)
    rows = np.arange(N)
    assert (np.abs(dist[rows, got] - dist[rows, want])[diff] <= 1e-4).all()
    assert diff.mean() <= 0.01


def _empty_init(x, K, rng):
    """K rows of x, the last two replaced by far-away points no row is
    nearest to: two clusters come out empty."""
    init = x[rng.choice(len(x), K, replace=False)].copy()
    init[-2:] = 1e3 + np.arange(2, dtype=np.float32)[:, None]
    return init


@pytest.mark.parametrize("empty", [False, True])
def test_lloyd_step_matches_jax(empty):
    """New centroids (with the sin-jittered split of the largest cluster
    for empty ones) and the mse agree with JAX's to 1e-5."""
    rng = np.random.default_rng(3)
    x = _clustered(1)
    K = 12
    init = (_empty_init(x, K, rng) if empty
            else x[rng.choice(len(x), K, replace=False)])
    want_c, want_mse = jax_kmeans.lloyd_step(jnp.asarray(x), jnp.asarray(init))
    got_c, got_mse = kmeans.lloyd_step(torch.from_numpy(x),
                                       torch.from_numpy(init))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got_mse), float(want_mse), rtol=1e-5)
    if empty:  # the split is really taken: the empty slots moved
        assert np.abs(got_c.numpy()[-2:] - init[-2:]).max() > 100


@pytest.mark.parametrize("empty", [False, True])
def test_kmeans_fit_from_matches_jax(empty):
    rng = np.random.default_rng(4)
    x = _clustered(2)
    K = 10
    init = (_empty_init(x, K, rng) if empty
            else x[rng.choice(len(x), K, replace=False)])
    want_c, want_mse = jax_kmeans.kmeans_fit_from(jnp.asarray(x),
                                                  jnp.asarray(init), iters=6)
    got_c, got_mse = kmeans.kmeans_fit_from(torch.from_numpy(x),
                                            torch.from_numpy(init), iters=6)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got_mse), float(want_mse), rtol=1e-5)


def test_assign_accumulate_chunks_rows_as_jax(monkeypatch):
    """Above _CHUNK_ELEMS the rows are chunked (at JAX's boundaries); the
    statistics equal the unchunked ones and JAX's chunked ones."""
    x = _clustered(5, N=997)
    c = x[:16].copy()
    whole = kmeans._assign_accumulate(torch.from_numpy(x), torch.from_numpy(c))
    monkeypatch.setattr(kmeans, "_CHUNK_ELEMS", 16 * 100)
    monkeypatch.setattr(jax_kmeans, "_CHUNK_ELEMS", 16 * 100)
    chunked = kmeans._assign_accumulate(torch.from_numpy(x),
                                        torch.from_numpy(c))
    jax_chunked = jax_kmeans._assign_accumulate(jnp.asarray(x), jnp.asarray(c))
    for a, b, j in zip(chunked, whole, jax_chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(a.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-4)


def test_kmeans_plusplus_init_returns_rows_of_x():
    x = _clustered(6, N=300)
    g = torch.Generator().manual_seed(0)
    init = kmeans.kmeans_plusplus_init(torch.from_numpy(x), 20, g).numpy()
    assert init.shape == (20, x.shape[1])
    for row in init:
        assert (np.abs(x - row[None]).max(-1) == 0).any()
    assert len(np.unique(init, axis=0)) == 20  # a chosen row has d2 = 0


def test_kmeans_fit_mse_close_to_jax():
    """Different random draws (torch's generator, not jax.random): the
    final mse is within 5% of JAX's on the same data. The data is one
    Gaussian blob, as the IVF's coarse quantizer sees it: with as many
    well-separated clusters as K, whether k-means++ seeds every cluster is
    a coin toss in either package, and the mse then depends on the draw."""
    x = np.random.default_rng(7).normal(size=(2000, 32)).astype(np.float32)
    _, want = jax_kmeans.kmeans_fit(jnp.asarray(x), 16, iters=15,
                                    key=jax.random.key(2022))
    _, got = kmeans.kmeans_fit(torch.from_numpy(x), 16, iters=15, seed=2022)
    assert abs(float(got) - float(want)) <= 0.05 * float(want), (got, want)


@pytest.mark.parametrize("n,max_points", [(100, 200), (5000, 700)])
def test_subsample_for_training_matches_jax(n, max_points):
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    np.testing.assert_array_equal(kmeans.subsample_for_training(x, max_points),
                                  jax_subsample(x, max_points))
