"""The port's PQ codebook ops against repconc_tpu.quant.codebook on the
same numpy-seeded inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repconc_tpu.quant import codebook as jax_cb
from repconc_tpu_torch.quant import codebook


def _data(seed, B=300, M=8, K=32, dsub=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, M * dsub)).astype(np.float32)
    c = rng.normal(size=(M, K, dsub)).astype(np.float32)
    return x, c


def test_pairwise_sqdist_matches_jax():
    x, c = _data(0)
    want = np.asarray(jax_cb.pairwise_sqdist(jnp.asarray(x), jnp.asarray(c)))
    got = codebook.pairwise_sqdist(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codes_agree_with_jax(seed):
    """fp32 argmin: equal except at near-ties, so >= 0.999 of entries."""
    x, c = _data(seed, B=2000)
    want = np.asarray(jax_cb.encode(jnp.asarray(x), jnp.asarray(c)))
    got = codebook.encode(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.999


def test_codes_exact_on_separated_data():
    """Points next to a known centroid get exactly that centroid's code."""
    rng = np.random.default_rng(4)
    M, K, dsub, B = 8, 32, 8, 500
    c = (rng.normal(size=(M, K, dsub)) * 10).astype(np.float32)
    truth = rng.integers(0, K, size=(B, M))
    x = c[np.arange(M)[None, :], truth] + rng.normal(size=(B, M, dsub)) * 1e-3
    x = x.reshape(B, -1).astype(np.float32)
    got = codebook.encode(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    want = np.asarray(jax_cb.encode(jnp.asarray(x), jnp.asarray(c)))
    np.testing.assert_array_equal(got, truth)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m_chunk", [1, 3, 4, None])
def test_m_chunking_changes_nothing(m_chunk):
    x, c = _data(5)
    full = codebook.encode(torch.from_numpy(x), torch.from_numpy(c), m_chunk=8)
    chunked = codebook.encode(torch.from_numpy(x), torch.from_numpy(c),
                              m_chunk=m_chunk)
    assert torch.equal(full, chunked)


@pytest.mark.parametrize("B,M,K", [(49152, 48, 256), (1000, 12, 256),
                                   (200000, 96, 256), (7, 5, 3)])
def test_auto_m_chunk_matches_jax(B, M, K):
    assert codebook._auto_m_chunk(B, M, K) == jax_cb._auto_m_chunk(B, M, K)
    assert codebook.round_to_divisor(M, 5) == jax_cb.round_to_divisor(M, 5)


def test_decode_gather_clamps_like_jax():
    rng = np.random.default_rng(6)
    _, c = _data(6)
    codes = rng.integers(-3, 40, size=(50, 8))  # out of range both sides
    want = np.asarray(jax_cb.decode_gather(jnp.asarray(codes), jnp.asarray(c)))
    got = codebook.decode_gather(torch.from_numpy(codes), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)


def test_normalizers_match_jax():
    x, c = _data(7)
    x[0, :8] = 0.0  # a zero subvector stays finite
    np.testing.assert_allclose(
        codebook.normalize_centroids(torch.from_numpy(c)).numpy(),
        np.asarray(jax_cb.normalize_centroids(jnp.asarray(c))), atol=1e-6)
    np.testing.assert_allclose(
        codebook.normalize_subvectors(torch.from_numpy(x), 8).numpy(),
        np.asarray(jax_cb.normalize_subvectors(jnp.asarray(x), 8)), atol=1e-6)


def test_constrained_encode_not_ported_yet():
    """The name predates the port of the Sinkhorn constraint: the
    constrained encode now runs and equals JAX's, except at near-ties
    (tests/test_torch_losses.py holds it per sample)."""
    x, c = _data(8)
    want = np.asarray(jax_cb.encode(jnp.asarray(x), jnp.asarray(c),
                                    use_constraint=True, sk_epsilon=0.05,
                                    sk_iters=50))
    got = codebook.encode(torch.from_numpy(x), torch.from_numpy(c),
                          use_constraint=True, sk_epsilon=0.05,
                          sk_iters=50).numpy()
    assert got.shape == want.shape
    assert (got == want).mean() >= 0.99
