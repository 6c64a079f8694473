"""The port's training losses, constrained encode and differentiable decode
against repconc_tpu.quant on the same numpy-seeded inputs.

Tolerances: loss values within 1e-5 relative; gradients within 1e-5 of
each array's largest |g| (both sides are fp32 sums of the same terms in
different orders); masks and codes exact, except codes at near-ties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repconc_tpu.quant import codebook as jax_cb
from repconc_tpu.quant import losses as jax_losses
from repconc_tpu.quant import sinkhorn as jax_sk
from repconc_tpu_torch.quant import codebook, losses


def _t(x):
    return torch.tensor(np.asarray(x))


def assert_grad_close(got, want, rel=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * scale)


def test_straight_through_value_and_gradients():
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(6, 8)).astype(np.float32),
                     requires_grad=True)
    c = torch.tensor(rng.normal(size=(6, 8)).astype(np.float32),
                     requires_grad=True)
    out = losses.straight_through(q, c)
    assert torch.equal(out, q)  # bit for bit, no q + c - c
    w = torch.tensor(rng.normal(size=(6, 8)).astype(np.float32))
    (out * w).sum().backward()
    assert torch.equal(q.grad, w) and torch.equal(c.grad, w)


def _ids(rng):
    """Doc ids with duplicates (among negatives and of positives) and
    query positives with padding and a judged positive among the
    negatives."""
    B = 6
    pos = np.arange(B, dtype=np.int32)
    neg = np.array([7, 8, 7, 2, 9, 9, 10, 3, 11, 12, 7, 5], dtype=np.int32)
    doc_ids = np.concatenate([pos, neg])
    positives = np.full((B, 3), -1, dtype=np.int32)
    positives[:, 0] = pos
    positives[1, 1] = 9
    positives[4, 1:] = [10, 7]
    return np.arange(B, dtype=np.int32), doc_ids, positives


def test_masks_match_jax():
    qids, doc_ids, positives = _ids(np.random.default_rng(0))
    want_fn = np.asarray(jax_losses.false_negative_mask(
        jnp.asarray(qids), jnp.asarray(doc_ids), jnp.asarray(positives)))
    got_fn = losses.false_negative_mask(_t(qids), _t(doc_ids),
                                        _t(positives)).numpy()
    np.testing.assert_array_equal(got_fn, want_fn)
    want_dup = np.asarray(jax_losses.duplicate_negative_mask(
        jnp.asarray(qids), jnp.asarray(doc_ids)))
    got_dup = losses.duplicate_negative_mask(_t(qids), _t(doc_ids)).numpy()
    np.testing.assert_array_equal(got_dup, want_dup)
    # the first occurrence of a repeated doc survives, the later ones go
    assert not got_dup[0, 6] and got_dup[0, 8] and got_dup[0, 16]
    assert got_fn[1, 10] and got_fn[4, 12] and got_fn[4, 6]


CASES = {  # name: (q_chunk, temperature, centroid_cos, topk hard negatives)
    "plain": (None, 1.0, False, None),
    "q_chunk": (2, 1.0, False, None),
    "q_chunk_non_divisor": (4, 1.0, False, None),
    "temperature": (3, 0.05, False, None),
    "centroid_cos": (None, 1.0, True, None),
    "topk_ties": (2, 0.5, False, 1),
    "topk_3": (3, 1.0, False, 3),
    "topk_all": (None, 1.0, False, 17),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_contrastive_loss_and_grads_match_jax(case):
    q_chunk, temp, mcc, topk = CASES[case]
    rng = np.random.default_rng(1)
    qids, doc_ids, positives = _ids(rng)
    q = rng.normal(size=(6, 16)).astype(np.float32)
    d = rng.normal(size=(18, 16)).astype(np.float32)
    if topk:  # two distinct docs with one embedding, the hardest negative
        d[14] = d[15] = 2.0 * q.sum(0)  # of most queries: a tie at the k-th
    mask = (np.asarray(jax_losses.false_negative_mask(
        jnp.asarray(qids), jnp.asarray(doc_ids), jnp.asarray(positives)))
        | np.asarray(jax_losses.duplicate_negative_mask(
            jnp.asarray(qids), jnp.asarray(doc_ids))))
    kw = dict(metric_centroid_cos=mcc, temperature=temp,
              dynamic_topk_hard_negative=topk)

    def jax_loss(qe, de):
        return jax_losses.contrastive_loss(qe, de, jnp.asarray(mask), 4,
                                           q_chunk=q_chunk, **kw)

    want, (gq_want, gd_want) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(q), jnp.asarray(d))
    qt = torch.tensor(q, requires_grad=True)
    dt = torch.tensor(d, requires_grad=True)
    got = losses.contrastive_loss(qt, dt, torch.tensor(mask), 4,
                                  q_chunk=q_chunk, **kw)
    got.backward()
    if case == "topk_ties":  # rows that keep both tied docs at k = 1
        sims = (q @ d.T - 1e4 * mask) / temp
        sims[np.arange(6), np.arange(6)] = -np.inf
        kth = np.sort(sims, axis=1)[:, -1:]
        assert ((sims >= kth).sum(1) > topk).sum() >= 3
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert_grad_close(qt.grad, gq_want)
    assert_grad_close(dt.grad, gd_want)


def test_mse_loss_matches_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(9, 12)).astype(np.float32)
    b = rng.normal(size=(9, 12)).astype(np.float32)
    want = float(jax_losses.mse_loss(jnp.asarray(a), jnp.asarray(b)))
    got = float(losses.mse_loss(torch.tensor(a), torch.tensor(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("m_chunk", [None, 1, 3])
def test_constrained_encode_matches_jax(m_chunk):
    """Codes equal JAX's (unchunked) except where the sample's two best
    log Q are within 1e-3 (near-ties); every chunking gives the same
    codes."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(200, 48)).astype(np.float32)
    c = rng.normal(size=(6, 16, 8)).astype(np.float32)
    want = np.asarray(jax_cb.encode(jnp.asarray(x), jnp.asarray(c),
                                    use_constraint=True, sk_epsilon=0.05,
                                    sk_iters=50))
    got = codebook.encode(torch.tensor(x), torch.tensor(c),
                          use_constraint=True, sk_epsilon=0.05, sk_iters=50,
                          m_chunk=m_chunk).numpy()
    full = codebook.encode(torch.tensor(x), torch.tensor(c),
                           use_constraint=True, sk_epsilon=0.05,
                           sk_iters=50).numpy()
    np.testing.assert_array_equal(got, full)
    d = np.asarray(jax_cb.pairwise_sqdist(jnp.asarray(x), jnp.asarray(c)))
    logq = np.asarray(jax_sk.sinkhorn_log(
        -jax_sk.center_distances(jnp.asarray(d)), 0.05, 50))
    top2 = np.sort(logq, axis=-1)[..., -2:]
    tied = (top2[..., 1] - top2[..., 0] < 1e-3).T
    assert got.shape == (200, 6)
    assert (got[~tied] == want[~tied]).all()


@pytest.mark.parametrize("b_chunk", [None, 7, 50])
def test_decode_and_its_centroid_gradient_match_jax(b_chunk):
    rng = np.random.default_rng(4)
    codes = rng.integers(0, 16, size=(50, 6)).astype(np.int32)
    codes[:10, 0] = 3  # one centroid gathered many times
    c = rng.normal(size=(6, 16, 8)).astype(np.float32)
    w = rng.normal(size=(50, 48)).astype(np.float32)

    def jax_fn(cent):
        return jnp.sum(jax_cb.decode(jnp.asarray(codes), cent) * w)

    want_val = np.asarray(jax_cb.decode(jnp.asarray(codes), jnp.asarray(c)))
    want_grad = np.asarray(jax.grad(jax_fn)(jnp.asarray(c)))
    ct = torch.tensor(c, requires_grad=True)
    out = codebook.decode(torch.tensor(codes), ct, b_chunk=b_chunk)
    np.testing.assert_array_equal(out.detach().numpy(), want_val)
    (out * torch.tensor(w)).sum().backward()
    assert_grad_close(ct.grad, want_grad)
    assert (ct.grad.numpy()[0, 3] != 0).all()
