"""ADC scoring and search: the port's plain scorer and CudaADCIndex (its
CPU path) against repconc_tpu.index.adc and the Pallas kernel in interpret
mode, on numpy-seeded inputs. The CUDA kernel itself is held against the
plain scorer on the card in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repconc_tpu.index import adc as jax_adc
from repconc_tpu_torch.index import adc
from repconc_tpu_torch.index.cuda_adc import CudaADCIndex, adc_scores


def _problem(seed, Q, N, M=8, K=32, dsub=4):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(Q, M * dsub)).astype(np.float32)
    c = rng.normal(size=(M, K, dsub)).astype(np.float32)
    codes = rng.integers(0, K, size=(N, M)).astype(np.uint8)
    return q, c, codes


def _exact_scores(q, c, codes):
    """float64 scores from the fp32 LUT, the yardstick for near-ties."""
    Q, M = q.shape[0], c.shape[0]
    lut = np.einsum("qmd,mkd->qmk", q.reshape(Q, M, -1).astype(np.float64), c)
    return lut[:, np.arange(M)[None, :], codes.astype(np.int64)].sum(-1), lut


def _bf16_tol(lut):
    """Per-query bound on how far the bf16 LUT moves two docs' scores
    apart: each entry rounds by <= |v| * 2^-8."""
    return 2 * np.abs(lut).max(-1).sum(-1) * 2.0 ** -8


def assert_same_topk(ids_a, ids_b, exact, tol):
    """Top-k ids equal except where the swapped docs are near-ties."""
    assert ids_a.shape == ids_b.shape
    tol = np.broadcast_to(np.asarray(tol, dtype=np.float64), (ids_a.shape[0],))
    for q in range(ids_a.shape[0]):
        diff = ids_a[q] != ids_b[q]
        gap = np.abs(exact[q, ids_a[q][diff]] - exact[q, ids_b[q][diff]])
        assert (gap <= tol[q]).all(), (q, gap.max(), tol[q])


def test_build_lut_matches_jax():
    q, c, _ = _problem(0, 5, 1)
    want = np.asarray(jax_adc.build_lut(jnp.asarray(q), jnp.asarray(c)))
    got = adc.build_lut(torch.from_numpy(q), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("Q,N", [(1, 1), (7, 300), (64, 1000)])
def test_plain_scorer_matches_jax_fp32(Q, N):
    q, c, codes = _problem(1, Q, N)
    lut = np.asarray(jax_adc.build_lut(jnp.asarray(q), jnp.asarray(c)))
    want = np.asarray(jax_adc.score_codes(jnp.asarray(lut), jnp.asarray(codes)))
    got = adc.score_codes_reference(torch.from_numpy(np.array(lut)),
                                    torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_plain_scorer_bf16_matches_pallas_interpret():
    """score_codes_reference on the bf16-rounded LUT equals the TPU kernel
    adc_scores_pallas, run in Pallas interpret mode as
    tests/test_pallas_adc.py runs it."""
    from repconc_tpu.index.pallas_adc import (_group_size, adc_scores_pallas,
                                              permute_lut)

    M, K = 16, 256
    q, c, codes = _problem(2, 128, 256, M=M, K=K)
    lut = jax_adc.build_lut(jnp.asarray(q), jnp.asarray(c))
    lut_perm = permute_lut(lut, _group_size(M, K)).astype(jnp.bfloat16)
    want = np.asarray(adc_scores_pallas(lut_perm, jnp.asarray(codes), K))
    lut_bf16 = torch.from_numpy(np.array(lut)).to(torch.bfloat16)
    got = adc.score_codes_reference(lut_bf16, torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_adc_scores_cpu_takes_plain_version():
    q, c, codes = _problem(3, 9, 130)
    lut = adc.build_lut(torch.from_numpy(q), torch.from_numpy(c))
    lut = lut.to(torch.bfloat16).contiguous()
    before = adc_scores.launches
    got = adc_scores(lut, torch.from_numpy(codes))
    assert adc_scores.launches == before  # no kernel launched on the CPU
    assert torch.equal(got, adc.score_codes_reference(lut, torch.from_numpy(codes)))


@pytest.mark.parametrize("bad", ["fp32_lut", "int64_codes", "M_mismatch",
                                 "K_too_big", "meta_device", "strided_lut"])
def test_adc_scores_rejects_what_it_cannot_take(bad):
    lut = torch.zeros((4, 8, 32), dtype=torch.bfloat16)
    codes = torch.zeros((10, 8), dtype=torch.uint8)
    if bad == "fp32_lut":
        lut = lut.float()
    elif bad == "int64_codes":
        codes = codes.long()
    elif bad == "M_mismatch":
        codes = codes[:, :4]
    elif bad == "K_too_big":
        lut = torch.zeros((4, 8, 300), dtype=torch.bfloat16)
    elif bad == "strided_lut":
        lut = torch.zeros((8, 4, 32), dtype=torch.bfloat16).transpose(0, 1)
    else:
        lut, codes = lut.to("meta"), codes.to("meta")
    with pytest.raises((TypeError, ValueError)):
        adc_scores(lut, codes)


@pytest.mark.parametrize("Q,N,topk,chunk", [
    (16, 1000, 10, 1 << 17),   # one chunk
    (16, 1000, 50, 300),       # ragged last chunk: pads masked to -inf
    (1, 777, 20, 128),         # Q=1
    (5, 40, 100, 16),          # topk > N
])
def test_index_cpu_path_matches_jax_adc_search(Q, N, topk, chunk):
    q, c, codes = _problem(4, Q, N)
    s_ref, i_ref = jax_adc.adc_search(q, codes, c, topk=topk)
    index = CudaADCIndex(codes, c, chunk_size=chunk, device="cpu")
    s, i = index.search(q, topk=topk)
    assert s.shape == s_ref.shape == (Q, min(topk, N))
    assert np.isfinite(s).all() and (i < N).all()
    exact, lut = _exact_scores(q, c, codes)
    tol = _bf16_tol(lut)
    assert_same_topk(i, np.asarray(i_ref), exact, tol)
    assert (np.abs(s - np.asarray(s_ref)) <= tol[:, None]).all()


def test_index_set_centroids():
    q, c, codes = _problem(5, 8, 500)
    c2 = np.random.default_rng(9).normal(size=c.shape).astype(np.float32)
    index = CudaADCIndex(codes, c, chunk_size=128, device="cpu")
    index.set_centroids(c2)
    _, i = index.search(q, topk=15)
    _, i_fresh = CudaADCIndex(codes, c2, chunk_size=128, device="cpu").search(q, 15)
    np.testing.assert_array_equal(i, i_fresh)
    _, i_ref = jax_adc.adc_search(q, codes, c2, topk=15)
    exact, lut = _exact_scores(q, c2, codes)
    assert_same_topk(i, np.asarray(i_ref), exact, _bf16_tol(lut))


@pytest.mark.parametrize("Q,N,topk", [(6, 500, 25), (3, 20, 50)])
def test_adc_search_matches_jax(Q, N, topk):
    """fp32 plain search: same scores, same ids except near-ties."""
    q, c, codes = _problem(6, Q, N)
    s_ref, i_ref = jax_adc.adc_search(q, codes, c, topk=topk, chunk_size=128)
    s, i = adc.adc_search(q, codes, c, topk=topk, chunk_size=100, device="cpu")
    np.testing.assert_allclose(s, s_ref, rtol=1e-5, atol=1e-5)
    exact, _ = _exact_scores(q, c, codes)
    assert_same_topk(i, np.asarray(i_ref), exact, 1e-4)


def test_batch_adc_search_matches_jax():
    q, c, codes = _problem(7, 11, 400)
    qids = np.array([f"q{j}" for j in range(11)])
    cids = np.array([f"d{j}" for j in range(400)])
    s_ref, d_ref = jax_adc.batch_adc_search(qids, q, cids, codes, c, topk=30,
                                            batch_size=4)
    s, d = adc.batch_adc_search(qids, q, cids, codes, c, topk=30, batch_size=4,
                                device="cpu")
    np.testing.assert_allclose(s, s_ref, rtol=1e-5, atol=1e-5)
    exact, _ = _exact_scores(q, c, codes)
    to_row = {cid: j for j, cid in enumerate(cids)}
    rows = np.vectorize(to_row.get)
    assert_same_topk(rows(d), rows(d_ref), exact, 1e-4)
    empty_s, empty_d = adc.batch_adc_search(qids[:0], q[:0], cids, codes, c,
                                            topk=30, device="cpu")
    assert empty_s.shape == (0, 30) and empty_d.shape == (0, 30)
