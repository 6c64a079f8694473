"""PQ and OPQ training and the OPQ warm-up on the port (index/kmeans.py::
pq_fit, pq_encode_chunked; index/opq.py; train/warmup.py) against the JAX
package. Each step is held to JAX's from the same start; a whole fit draws
its random rotation and seeds from torch generators, which differ from
jax.random's, so it is held to quality bounds."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repconc_tpu.core.config import EncoderConfig as JaxEncoderConfig
from repconc_tpu.core.config import RepConcConfig as JaxRepConcConfig
from repconc_tpu.index import kmeans as jax_kmeans
from repconc_tpu.index import opq as jax_opq
from repconc_tpu.train import warmup as jax_warmup
from repconc_tpu_torch.core.config import EncoderConfig, RepConcConfig
from repconc_tpu_torch.index import kmeans, opq
from repconc_tpu_torch.models.repconc_model import RepConcModel
from repconc_tpu_torch.train import warmup

HIGHEST = jax.lax.Precision.HIGHEST


def correlated(rng, n, d, mix):
    """Gaussian rows mixed by I + mix * B (B Gaussian / sqrt(d)): mix sets
    how far the covariance is from the identity, and its conditioning."""
    b = rng.normal(size=(d, d)) / np.sqrt(d)
    return (rng.normal(size=(n, d)) @ (np.eye(d) + mix * b)).astype(np.float32)


def init_from_rows(rng, x, M, K):
    """(M, K, dsub) centroids taken from K distinct rows of x."""
    rows = x[rng.choice(len(x), K, replace=False)]
    return np.ascontiguousarray(rows.reshape(K, M, -1).transpose(1, 0, 2))


def codes_equal_but_near_ties(got, want, x, centroids, tol=1e-4):
    """Codes equal, except where the two centroids' squared distances to
    the subvector differ by less than tol relative (fp64)."""
    M = centroids.shape[0]
    xs = x.reshape(len(x), M, -1).astype(np.float64)
    c = centroids.astype(np.float64)
    rows, ms = np.nonzero(got != want)
    for r, m in zip(rows, ms):
        dg = ((xs[r, m] - c[m, got[r, m]]) ** 2).sum()
        dw = ((xs[r, m] - c[m, want[r, m]]) ** 2).sum()
        assert abs(dg - dw) <= tol * max(dw, 1e-12), (r, m, dg, dw)
    return len(rows)


@pytest.mark.parametrize("iters", [1, 5])
def test_pq_fit_from_init_matches_jax(rng, iters):
    x = correlated(rng, 2000, 32, 0.5)
    init = init_from_rows(rng, x, 4, 16)
    want_c, want_mse = jax_kmeans.pq_fit(jnp.asarray(x), 4, 16, iters=iters,
                                         init_centroids=jnp.asarray(init))
    got_c, got_mse = kmeans.pq_fit(torch.from_numpy(x), 4, 16, iters=iters,
                                   init_centroids=torch.from_numpy(init))
    assert got_c.shape == (4, 16, 8) and got_mse.shape == (4,)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(got_mse.numpy(), np.asarray(want_mse),
                               rtol=1e-5)


def test_pq_fit_seeded_is_deterministic_and_reduces_error(rng):
    x = torch.from_numpy(correlated(rng, 1000, 16, 0.5))
    c1, m1 = kmeans.pq_fit(x, 4, 8, iters=10, seed=3)
    c2, m2 = kmeans.pq_fit(x, 4, 8, iters=10, seed=3)
    assert torch.equal(c1, c2) and torch.equal(m1, m2)
    _, m_short = kmeans.pq_fit(x, 4, 8, iters=1, seed=3)
    assert float(m1.sum()) < float(m_short.sum())


@pytest.mark.parametrize("chunk", [300, 1 << 16])
def test_pq_encode_chunked_matches_jax(rng, chunk):
    x = correlated(rng, 1000, 32, 0.5)
    cent = init_from_rows(rng, x, 8, 16)
    want = jax_kmeans.pq_encode_chunked(jnp.asarray(x), jnp.asarray(cent),
                                        chunk=chunk)
    got = kmeans.pq_encode_chunked(x, cent, chunk=chunk, device="cpu")
    assert got.dtype == np.uint8 and got.shape == (1000, 8)
    assert codes_equal_but_near_ties(got, want, x, cent) <= 2
    from_tensor = kmeans.pq_encode_chunked(torch.from_numpy(x), cent,
                                           chunk=chunk, device="cpu")
    np.testing.assert_array_equal(from_tensor, got)


def jax_opq_step(x, R, centroids, pq_iters):
    """One outer iteration of repconc_tpu/index/opq.py:74-83."""
    x, R = jnp.asarray(x), jnp.asarray(R)
    M, K = centroids.shape[:2]
    y = jnp.dot(x, R, precision=HIGHEST)
    cent, _ = jax_kmeans.pq_fit(y, M, K, iters=pq_iters,
                                init_centroids=jnp.asarray(centroids))
    y_hat = jax_opq._pq_reconstruct(y, cent)
    u, _, vt = jnp.linalg.svd(jnp.dot(x.T, y_hat, precision=HIGHEST),
                              full_matrices=False)
    return np.asarray(jnp.dot(u, vt, precision=HIGHEST)), np.asarray(cent)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_one_opq_step_matches_jax(seed):
    """R = U V^T of a full-rank covariance does not depend on the SVD's
    sign choices; its rounding grows with the covariance's condition
    number, which this data keeps below 100."""
    rng = np.random.default_rng(seed)
    x = correlated(rng, 2000, 32, 0.3)
    init = init_from_rows(rng, x, 4, 16)
    R0 = np.linalg.qr(rng.normal(size=(32, 32)))[0].astype(np.float32)
    want_R, want_c = jax_opq_step(x, R0, init, 4)
    got_R, got_c = opq.opq_step(torch.from_numpy(x), torch.from_numpy(R0),
                                torch.from_numpy(init), 4)
    y_hat = opq._pq_reconstruct(torch.from_numpy(x @ R0), got_c).numpy()
    s = np.linalg.svd(x.T.astype(np.float64) @ y_hat, compute_uv=False)
    assert s[0] / s[-1] < 100
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_R.numpy(), want_R, rtol=0, atol=1e-5)


def test_pq_reconstruct_matches_jax(rng):
    x = correlated(rng, 500, 32, 0.5)
    cent = init_from_rows(rng, x, 8, 16)
    want = np.asarray(jax_opq._pq_reconstruct(jnp.asarray(x),
                                              jnp.asarray(cent)))
    got = opq._pq_reconstruct(torch.from_numpy(x), torch.from_numpy(cent))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,as_tensor", [(5000, False), (5000, True),
                                         (100, False)])
def test_subsample_indices_equal_jax(rng, n, as_tensor):
    x = rng.normal(size=(n, 4)).astype(np.float32)
    want = jax_opq.subsample_for_training(x, 1000, seed=9)
    got = kmeans.subsample_for_training(
        torch.from_numpy(x) if as_tensor else x, 1000, seed=9)
    np.testing.assert_array_equal(np.asarray(got), want)


def test_random_rotation_is_orthogonal_and_seeded():
    R = opq.random_rotation(48, seed=4, device="cpu")
    torch.testing.assert_close(R @ R.T, torch.eye(48), rtol=0, atol=1e-5)
    assert torch.equal(R, opq.random_rotation(48, seed=4, device="cpu"))


def pq_mse(x, rotation, centroids):
    """Mean squared reconstruction error of x's rows, summed over dims."""
    y = x @ rotation.T
    rec = opq._pq_reconstruct(y, centroids)
    return float(((y - rec) ** 2).sum(-1).mean())


def test_opq_fit_quality_against_jax():
    """Correlated full-rank data, where a rotation pays, at a size where
    both packages' fits converge: the port's OPQ is orthogonal, beats plain
    PQ on the same data, and ends within 2% of JAX's OPQ MSE."""
    n, d, M, K = 4000, 32, 8, 16
    x = correlated(np.random.default_rng(7), n, d, 1.0)
    xt = torch.from_numpy(x)
    R, cent, mse = opq.opq_fit(xt, M, K, outer_iters=20, pq_iters=4,
                               final_pq_iters=25, seed=1)
    torch.testing.assert_close(R @ R.T, torch.eye(d), rtol=0, atol=1e-4)
    got = pq_mse(xt, R, cent)
    assert abs(got - float(mse.sum())) <= 1e-3 * got
    pq_c, pq_m = kmeans.pq_fit(xt, M, K, iters=45, seed=1)
    assert got < 0.9 * float(pq_m.sum())
    jR, jc, jmse = jax_opq.opq_fit(jnp.asarray(x), M=M, K=K, outer_iters=20,
                                   pq_iters=4, final_pq_iters=25,
                                   key=jax.random.key(1))
    want = pq_mse(xt, torch.tensor(np.asarray(jR)), torch.tensor(np.asarray(jc)))
    assert got <= 1.02 * want, (got, want)


def tiny_config(metric, M=4, K=16, d=32):
    enc = dict(vocab_size=40, hidden_size=d, num_hidden_layers=1,
               num_attention_heads=4, intermediate_size=64,
               max_position_embeddings=32)
    return (RepConcConfig(encoder=EncoderConfig(**enc), MCQ_M=M, MCQ_K=K,
                          similarity_metric=metric),
            JaxRepConcConfig(encoder=JaxEncoderConfig(**enc), MCQ_M=M,
                             MCQ_K=K, similarity_metric=metric))


@pytest.mark.parametrize("metric", ["METRIC_IP", "METRIC_CENTROID_COS"])
def test_warmup_codes_for_given_rotation_and_centroids(metric, monkeypatch):
    """Both packages' warmup_from_embeds with the same OPQ result (their
    opq_fit replaced by one that returns it): the same rotation and
    centroids installed, and the same codes except near-ties."""
    rng = np.random.default_rng(3)
    x = correlated(rng, 3000, 32, 0.5)
    R = np.linalg.qr(rng.normal(size=(32, 32)))[0].astype(np.float32)
    cent = init_from_rows(rng, x @ R.T, 4, 16)
    mse = np.zeros(4, np.float32)
    monkeypatch.setattr(warmup, "opq_fit", lambda train, **kw: (
        torch.from_numpy(R), torch.from_numpy(cent), torch.from_numpy(mse)))
    monkeypatch.setattr(jax_warmup, "opq_fit", lambda train, **kw: (
        jnp.asarray(R), jnp.asarray(cent), jnp.asarray(mse)))
    config, jax_config = tiny_config(metric)
    model, codes = warmup.warmup_from_embeds(
        x, RepConcModel(config), max_train_points=1000, encode_chunk=700,
        device="cpu")
    params, want = jax_warmup.warmup_from_embeds(
        x, jax_config, {}, max_train_points=1000, encode_chunk=700)
    np.testing.assert_array_equal(model.rotation.detach().numpy(), R)
    np.testing.assert_allclose(model.centroids.detach().numpy(),
                               np.asarray(params["centroids"]), rtol=0,
                               atol=1e-7)
    rotated = torch.from_numpy(x) @ torch.from_numpy(R).T
    if metric == "METRIC_CENTROID_COS":
        from repconc_tpu_torch.quant import codebook

        rotated = codebook.normalize_subvectors(rotated, 4)
    assert codes.dtype == np.uint8 and codes.shape == (3000, 4)
    assert codes_equal_but_near_ties(codes, want, rotated.numpy(),
                                     model.centroids.detach().numpy()) <= 3


def test_warmup_fits_and_encodes_with_its_own_model(rng):
    """Unpatched: the codes are the fitted model's argmin codes of the
    rotated corpus, and a device-side corpus tensor gives the same result
    as a host array."""
    x = correlated(rng, 2000, 32, 0.5)
    config, _ = tiny_config("METRIC_IP")
    kw = dict(max_train_points=1500, outer_iters=3, pq_iters=2,
              final_pq_iters=4, encode_chunk=512, device="cpu")
    model, codes = warmup.warmup_from_embeds(x, RepConcModel(config), **kw)
    rotated = torch.from_numpy(x) @ model.rotation.detach().T
    want = kmeans.pq_assign(rotated, model.centroids.detach()).numpy()
    np.testing.assert_array_equal(codes, want)
    model2, codes2 = warmup.warmup_from_embeds(torch.from_numpy(x),
                                               RepConcModel(config), **kw)
    np.testing.assert_array_equal(codes2, codes)
    assert torch.equal(model2.centroids, model.centroids)
