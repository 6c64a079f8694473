"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Each test skips without a GPU. This file imports no JAX, so it
runs where JAX is absent:

    REPCONC_TEST_TPU=1 python -m pytest tests/test_torch_cuda.py -q

(REPCONC_TEST_TPU=1 keeps tests/conftest.py from importing jax.)
"""
import numpy as np
import pytest
import torch

from repconc_tpu_torch.index.adc import (adc_search, build_lut,
                                         score_codes_reference)
from repconc_tpu_torch.index.cuda_adc import CudaADCIndex, adc_scores


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("Q,N,M", [(1, 1, 12), (129, 1000, 12), (37, 5003, 48),
                                   (9, 777, 96), (1200, 131072, 12),
                                   (3, 100, 4)])
def test_adc_scan_matches_plain(cuda, Q, N, M):
    g = torch.Generator(device=cuda).manual_seed(Q * 7 + N + M)
    lut = torch.randn((Q, M, 256), generator=g, device=cuda).to(torch.bfloat16)
    codes = torch.randint(0, 256, (N, M), generator=g, device=cuda,
                          dtype=torch.uint8)
    before = adc_scores.launches
    got = adc_scores(lut, codes)
    torch.cuda.synchronize()
    assert adc_scores.launches == before + 1
    want = score_codes_reference(lut, codes)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_adc_scan_small_k_clamps_like_plain(cuda):
    """K < 256: codes above K - 1 clamp to K - 1 in both versions."""
    g = torch.Generator(device=cuda).manual_seed(1)
    lut = torch.randn((5, 8, 16), generator=g, device=cuda).to(torch.bfloat16)
    codes = torch.randint(0, 256, (300, 8), generator=g, device=cuda,
                          dtype=torch.uint8)
    torch.testing.assert_close(adc_scores(lut, codes),
                               score_codes_reference(lut, codes),
                               rtol=1e-5, atol=1e-5)


def test_adc_scan_rejects_non_contiguous(cuda):
    lut = torch.zeros((4, 8, 32), dtype=torch.bfloat16, device=cuda)
    codes = torch.zeros((8, 10), dtype=torch.uint8, device=cuda).T
    with pytest.raises(ValueError):
        adc_scores(lut, codes)


def test_index_on_card_matches_cpu_path(cuda):
    rng = np.random.default_rng(8)
    q = rng.normal(size=(33, 48)).astype(np.float32)
    c = rng.normal(size=(12, 256, 4)).astype(np.float32)
    codes = rng.integers(0, 256, size=(3000, 12)).astype(np.uint8)
    s_gpu, i_gpu = CudaADCIndex(codes, c, chunk_size=1000, device=cuda).search(q, 100)
    s_cpu, i_cpu = CudaADCIndex(codes, c, chunk_size=1000, device="cpu").search(q, 100)
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=1e-5, atol=1e-5)
    # every returned id carries its own plain score, and ids differ only
    # where the plain scores of the two ids are near-ties
    lut = build_lut(torch.as_tensor(q, device=cuda),
                    torch.as_tensor(c, device=cuda)).to(torch.bfloat16)
    plain = score_codes_reference(
        lut, torch.as_tensor(codes, device=cuda)).cpu().numpy()
    at_gpu = np.take_along_axis(plain, i_gpu, axis=1)
    at_cpu = np.take_along_axis(plain, i_cpu, axis=1)
    np.testing.assert_allclose(at_gpu, s_gpu, rtol=1e-5, atol=1e-5)
    assert (np.abs(at_gpu - at_cpu)[i_gpu != i_cpu] <= 1e-5).all()
    s_fp32, _ = adc_search(q, codes, c, topk=100, device=cuda)
    assert np.isfinite(s_fp32).all()


def test_resolve_device_matches_tensor_devices(cuda):
    from repconc_tpu_torch.core.device import resolve_device

    dev = resolve_device("cuda")
    assert torch.zeros(1, device="cuda").device == dev
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def _tiles(g, dev, T, Q, nlist, Lpad, M, K, empty_share):
    """Random work tiles: each slot holds a query or is empty (index Q)."""
    work_cell = torch.randint(0, nlist, (T,), generator=g, device=dev,
                              dtype=torch.int32)
    qidx = torch.randint(0, Q, (T, 32), generator=g, device=dev,
                         dtype=torch.int32)
    empty = torch.rand((T, 32), generator=g, device=dev) < empty_share
    qidx[empty] = Q
    codes = torch.randint(0, K, (nlist, Lpad, M), generator=g, device=dev,
                          dtype=torch.uint8)
    lut = torch.randn((Q, M, K), generator=g, device=dev)
    return work_cell, qidx, codes, lut


@pytest.mark.parametrize("T,Q,nlist,Lpad,M", [
    (1, 1, 1, 128, 12), (37, 50, 16, 640, 12), (64, 200, 32, 256, 48),
    (9, 40, 8, 2048, 12), (5, 7, 4, 100, 8)])
@pytest.mark.parametrize("lut_dtype", ["bf16", "int8"])
def test_ivf_scan_matches_plain(cuda, T, Q, nlist, Lpad, M, lut_dtype):
    """K2 / K3 against score_work_tiles_reference: bit for bit (same adds
    in the same order), empty slots exact zeros."""
    from repconc_tpu_torch.index.adc import group_size, quantize_lut_int8
    from repconc_tpu_torch.index.cuda_ivf import (score_work_tiles,
                                                  score_work_tiles_reference)

    g = torch.Generator(device=cuda).manual_seed(T + Q + Lpad + M)
    work_cell, qidx, codes, lut = _tiles(g, cuda, T, Q, nlist, Lpad, M, 256,
                                         0.4)
    scales = None
    if lut_dtype == "int8":
        lut, scales = quantize_lut_int8(lut, group_size(M, 256))
        scales = torch.cat([scales, scales.new_zeros((1, scales.shape[1]))])
    else:
        lut = lut.to(torch.bfloat16)
    lut = torch.cat([lut, lut.new_zeros((1,) + lut.shape[1:])]).contiguous()
    before = dict(score_work_tiles.launches)
    got = score_work_tiles(work_cell, qidx, lut, codes, scales)
    torch.cuda.synchronize()
    assert score_work_tiles.launches[lut_dtype] == before[lut_dtype] + 1
    want = score_work_tiles_reference(work_cell, qidx, lut, codes, scales)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert bool((got[qidx == Q] == 0).all())


@pytest.mark.parametrize("Q,N,M", [(1, 1, 12), (129, 1000, 12),
                                   (37, 5003, 48), (1200, 131072, 12)])
def test_adc_scan_int8_matches_plain(cuda, Q, N, M):
    from repconc_tpu_torch.index.adc import (group_size, quantize_lut_int8,
                                             score_codes_int8_reference)
    from repconc_tpu_torch.index.cuda_adc import adc_scores_int8

    g = torch.Generator(device=cuda).manual_seed(Q + N + M)
    lut, scales = quantize_lut_int8(
        torch.randn((Q, M, 256), generator=g, device=cuda), group_size(M, 256))
    codes = torch.randint(0, 256, (N, M), generator=g, device=cuda,
                          dtype=torch.uint8)
    before = adc_scores_int8.launches
    got = adc_scores_int8(lut, scales, codes)
    torch.cuda.synchronize()
    assert adc_scores_int8.launches == before + 1
    torch.testing.assert_close(got, score_codes_int8_reference(lut, scales,
                                                               codes),
                               rtol=1e-5, atol=1e-5)


def _random_ivf(seed, N=6000, M=12, K=256, dsub=4, nlist=64):
    from repconc_tpu_torch.index.ivf import build_ivf_from_codes

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, K, size=(N, M)).astype(np.uint8)
    cent = rng.normal(size=(M, K, dsub)).astype(np.float32)
    index = build_ivf_from_codes(codes, cent, nlist=nlist, kmeans_iters=5,
                                 pad_quantile=0.8, device="cpu")
    q = rng.normal(size=(40, M * dsub)).astype(np.float32)
    return index, codes, cent, q


@pytest.mark.parametrize("lut_dtype", ["bf16", "int8"])
def test_ivf_index_on_card_matches_cpu_path(cuda, lut_dtype):
    """CudaIVFIndex on the card (K2 / K3 and K1 on the spill) against the
    same index on the CPU (their plain versions): equal scores, ids equal
    except near-ties."""
    from repconc_tpu_torch.index.cuda_ivf import CudaIVFIndex

    index, _, _, q = _random_ivf(3)
    assert len(index.spill_ids) > 0
    s_gpu, i_gpu = CudaIVFIndex(index, device=cuda).search(
        q, topk=50, nprobe=8, lut_dtype=lut_dtype)
    s_cpu, i_cpu = CudaIVFIndex(index, device="cpu").search(
        q, topk=50, nprobe=8, lut_dtype=lut_dtype)
    np.testing.assert_allclose(s_gpu, s_cpu, rtol=1e-5, atol=1e-5)
    assert (i_gpu == i_cpu).mean() >= 0.99


def test_ivf_full_probe_equals_flat_index(cuda):
    """nprobe = nlist scores every doc: the ranking is CudaADCIndex's (K2
    and K1 add the same bf16 entries in the same order)."""
    from repconc_tpu_torch.index.cuda_ivf import CudaIVFIndex

    index, codes, cent, q = _random_ivf(4)
    s_ivf, i_ivf = CudaIVFIndex(index, device=cuda).search(
        q, topk=100, nprobe=index.nlist)
    s_flat, i_flat = CudaADCIndex(codes, cent, device=cuda).search(q, 100)
    np.testing.assert_array_equal(s_ivf, s_flat)
    for r in range(len(q)):  # ids differ only among docs tied at the cut
        above = s_flat[r] > s_flat[r, -1]
        assert set(i_ivf[r][above]) == set(i_flat[r][above]), r


def _pass_inputs(dev, Q, N, M, npad, dup_rows=0, seed=0):
    """A bf16 LUT and N + npad code rows (npad pad rows past n_valid = N);
    with dup_rows, the first dup_rows rows repeat through the corpus, so
    each score is shared by many docs (exact ties at tau)."""
    g = torch.Generator(device=dev).manual_seed(seed + Q * 13 + N + M)
    lut = torch.randn((Q, M, 256), generator=g, device=dev).to(torch.bfloat16)
    codes = torch.randint(0, 256, (N + npad, M), generator=g, device=dev,
                          dtype=torch.uint8)
    if dup_rows:
        reps = -(-N // dup_rows)
        codes[:N] = codes[:dup_rows].repeat(reps, 1)[:N]
    return lut, codes


def _same_candidates(got, want, cap):
    """(cand_s, cand_i, count) of the kernel against the plain version:
    counts equal; the stored slots are the same set of ids with bit-equal
    scores (within cap), or, past cap, cap distinct passing ids whose
    scores are their plain scores."""
    (s_g, i_g, c_g), (s_w, i_w, c_w) = got, want
    assert torch.equal(c_g.cpu(), c_w.cpu())
    for q in range(s_g.shape[0]):
        n = min(int(c_w[q]), cap)
        assert bool((i_g[q, n:] == -1).all()) and bool(
            torch.isinf(s_g[q, n:]).all())
        ids, order = torch.sort(i_g[q, :n])
        if int(c_w[q]) <= cap:
            assert torch.equal(ids, i_w[q, :n])
            assert torch.equal(s_g[q, :n][order], s_w[q, :n])
        else:
            assert torch.unique(ids).numel() == n


@pytest.mark.parametrize("Q,N,M,npad,G", [
    (1, 1, 12, 0, 1), (129, 100_003, 12, 77, 2048), (37, 5003, 48, 5, 64),
    (9, 7777, 96, 0, 300), (1200, 131072, 12, 0, 4096), (3, 1000, 10, 24, 8)])
def test_adc_group_max_matches_plain(cuda, Q, N, M, npad, G):
    """Pass 1 against adc_group_max_reference: bit for bit; pad rows past
    n_valid belong to no group."""
    from repconc_tpu_torch.index.adc import adc_group_max_reference
    from repconc_tpu_torch.index.cuda_adc import adc_group_max

    lut, codes = _pass_inputs(cuda, Q, N, M, npad)
    codes[N:] = 0  # pad rows: any score, never part of a group
    before = adc_group_max.launches
    got = adc_group_max(lut, codes, N, G)
    torch.cuda.synchronize()
    assert adc_group_max.launches == before + 1
    assert torch.equal(got, adc_group_max_reference(lut, codes, N, G))


@pytest.mark.parametrize("Q,N,M,npad,dup,cap", [
    (129, 100_003, 12, 77, 0, 4096), (37, 5003, 48, 5, 0, 64),
    (9, 7777, 96, 0, 0, 300), (5, 20_000, 12, 0, 40, 100)])
@pytest.mark.parametrize("with_gmax", [False, True])
def test_adc_filter_matches_plain(cuda, Q, N, M, npad, dup, cap, with_gmax):
    """Pass 2 against adc_filter_reference at a threshold from pass 1: the
    same counts, the same candidate set with bit-equal scores (in another
    order), and past cap only passing docs; skipping groups by gmax
    changes nothing."""
    from repconc_tpu_torch.index.adc import (adc_filter_reference,
                                             adc_group_max_reference)
    from repconc_tpu_torch.index.cuda_adc import adc_filter

    lut, codes = _pass_inputs(cuda, Q, N, M, npad, dup_rows=dup)
    G = 512
    gmax = adc_group_max_reference(lut, codes, N, G)
    tau = torch.topk(gmax, 50, dim=1).values[:, -1].contiguous()
    before = adc_filter.launches
    got = adc_filter(lut, codes, N, tau, cap, gmax if with_gmax else None)
    torch.cuda.synchronize()
    assert adc_filter.launches == before + 1
    _same_candidates(got, adc_filter_reference(lut, codes, N, tau, cap), cap)


@pytest.mark.parametrize("Q,N,M,topk,dup", [
    (129, 100_003, 12, 1000, 0), (33, 3000, 12, 100, 0),
    (7, 500, 48, 1000, 0), (16, 50_000, 12, 100, 25)])
def test_adc_topk_on_card_matches_unfused(cuda, Q, N, M, topk, dup):
    """The two-pass search against a top-k over the K1 scores: scores bit
    for bit, ids equal except among exact ties (where the two-pass search
    takes the lower id); the tied case forces a rerun of pass 2."""
    from repconc_tpu_torch.index.cuda_adc import adc_topk

    lut, codes = _pass_inputs(cuda, Q, N, M, 64, dup_rows=dup)
    reruns = adc_topk.reruns
    s, i = adc_topk(lut, codes, N, topk)
    scores = adc_scores(lut, codes[:N])
    s_ref, _ = torch.topk(scores, min(topk, N), dim=1)
    assert torch.equal(s, s_ref)
    assert torch.equal(torch.gather(scores, 1, i), s)
    assert bool((i[:, 1:] > i[:, :-1])[s[:, 1:] == s[:, :-1]].all())
    assert adc_topk.reruns == reruns + (1 if dup else 0)


def _pass_tiles(dev, Q, nlist, nprobe, Lpad, M, lut_dtype, seed=0,
                distinct_rows=0):
    """Work tiles from random distinct cells per query (group_pairs), cells
    filled to random lengths (some empty, the rest trailing pads, as
    fill_cells leaves them) with consecutive corpus ids, and the (Q + 1)
    LUT of either type; with distinct_rows, every cell repeats the same few
    code rows, so many docs tie."""
    from repconc_tpu_torch.index.cuda_ivf import (cell_lengths, group_pairs,
                                                  make_lut_z)

    g = torch.Generator(device=dev).manual_seed(seed + Q + nlist + Lpad + M)
    cells = torch.argsort(torch.rand((Q, nlist), generator=g, device=dev),
                          dim=1)[:, :nprobe]
    row, work_cell, slot_pair = group_pairs(cells, Q, nlist, nprobe)
    lens = torch.randint(0, Lpad + 1, (nlist,), generator=g, device=dev)
    lens[torch.rand(nlist, generator=g, device=dev) < 0.1] = 0
    real = torch.arange(Lpad, device=dev)[None, :] < lens[:, None]
    cell_ids = torch.full((nlist, Lpad), -1, dtype=torch.int32, device=dev)
    cell_ids[real] = torch.arange(int(real.sum()), dtype=torch.int32,
                                  device=dev)
    codes = torch.randint(0, 256, (nlist, Lpad, M), generator=g, device=dev,
                          dtype=torch.uint8)
    if distinct_rows:
        codes[:] = codes[0, :distinct_rows].repeat(
            -(-Lpad // distinct_rows), 1)[:Lpad]
    q = torch.randn((Q, M * 4), generator=g, device=dev)
    cent = torch.randn((M, 256, 4), generator=g, device=dev)
    lut_z, scales_z = make_lut_z(q, cent, lut_dtype)
    return dict(row=row, cells=cells, work_cell=work_cell,
                slot_pair=slot_pair, cell_codes=codes, cell_ids=cell_ids,
                cell_len=cell_lengths(cell_ids), lut_z=lut_z,
                scales_z=scales_z)


PASS_SHAPES = [  # Q, nlist, nprobe, Lpad, M: k2_check's, smaller Q
    (300, 4096, 64, 256, 48), (300, 1024, 64, 2048, 12),
    (256, 256, 16, 640, 12), (1, 8, 1, 256, 12), (37, 16, 5, 100, 8)]


@pytest.mark.parametrize("Q,nlist,nprobe,Lpad,M", PASS_SHAPES)
@pytest.mark.parametrize("lut_dtype", ["bf16", "int8"])
def test_ivf_group_max_matches_plain(cuda, Q, nlist, nprobe, Lpad, M,
                                     lut_dtype):
    """Pass 1 against ivf_group_max_reference: bit for bit; pads and runs
    with no real doc at -inf."""
    from repconc_tpu_torch.index.cuda_ivf import (ivf_group_max,
                                                  ivf_group_max_reference)

    t = _pass_tiles(cuda, Q, nlist, nprobe, Lpad, M, lut_dtype)
    args = (t["work_cell"], t["slot_pair"], t["lut_z"], t["cell_codes"],
            t["cell_len"], nprobe, t["scales_z"])
    before = dict(ivf_group_max.launches)
    got = ivf_group_max(*args)
    torch.cuda.synchronize()
    assert ivf_group_max.launches[lut_dtype] == before[lut_dtype] + 1
    assert torch.equal(got, ivf_group_max_reference(*args))


def _same_ivf_candidates(got, want, cap):
    """Pass 2 on the card against its plain version: equal counts; within
    cap the same ids with bit-equal scores (both sorted by id), past cap
    distinct ids among the plain version's passing docs."""
    (s_g, i_g, c_g), (s_w, i_w, c_w) = got, want
    assert torch.equal(c_g, c_w)
    for q in range(s_g.shape[0]):
        n = min(int(c_w[q]), cap)
        assert bool((i_g[q, n:] == -1).all()) and bool(
            torch.isneginf(s_g[q, n:]).all())
        ids_g, order_g = torch.sort(i_g[q, :n])
        if int(c_w[q]) <= cap:
            ids_w, order_w = torch.sort(i_w[q, :n])
            assert torch.equal(ids_g, ids_w)
            assert torch.equal(s_g[q, :n][order_g], s_w[q, :n][order_w])
        else:
            assert torch.unique(ids_g).numel() == n


@pytest.mark.parametrize("Q,nlist,nprobe,Lpad,M", PASS_SHAPES)
@pytest.mark.parametrize("lut_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("with_gmax", [False, True])
def test_ivf_filter_matches_plain(cuda, Q, nlist, nprobe, Lpad, M, lut_dtype,
                                  with_gmax):
    """Pass 2 against ivf_filter_reference at a threshold from pass 1 (k =
    100, or -inf where a query has fewer runs): the same counts and
    candidate sets with bit-equal scores; a cap of 60 leaves some queries
    past it; skipping runs by gmax changes nothing."""
    from repconc_tpu_torch.index.cuda_ivf import (ivf_filter,
                                                  ivf_filter_reference,
                                                  ivf_group_max_reference)

    t = _pass_tiles(cuda, Q, nlist, nprobe, Lpad, M, lut_dtype, seed=1)
    tiles = (t["work_cell"], t["slot_pair"], t["lut_z"], t["cell_codes"])
    gmax = ivf_group_max_reference(*tiles, t["cell_len"], nprobe,
                                   t["scales_z"])
    flat = gmax.reshape(Q, -1)
    tau = torch.topk(flat, min(100, flat.shape[1]), dim=1).values[:, -1]
    tau = tau.contiguous()
    rest = (t["cell_ids"], t["cell_len"], nprobe, tau)
    for cap in (60, 4000):
        before = dict(ivf_filter.launches)
        got = ivf_filter(*tiles, *rest, cap, gmax if with_gmax else None,
                         t["scales_z"])
        torch.cuda.synchronize()
        assert ivf_filter.launches[lut_dtype] == before[lut_dtype] + 1
        want = ivf_filter_reference(*tiles, *rest, cap, t["scales_z"])
        _same_ivf_candidates(got, want, cap)


@pytest.mark.parametrize("Q,nlist,nprobe,Lpad,M,topk,dup", [
    (300, 4096, 64, 256, 48, 1000, 0), (300, 1024, 64, 2048, 12, 1000, 0),
    (256, 256, 16, 640, 12, 100, 0), (64, 256, 16, 640, 12, 50, 3),
    (37, 16, 5, 100, 8, 10, 0)])
@pytest.mark.parametrize("lut_dtype", ["bf16", "int8"])
def test_ivf_topk_on_card_matches_unfused(cuda, Q, nlist, nprobe, Lpad, M,
                                          topk, dup, lut_dtype):
    """The two-pass IVF search against K2 / K3 + regroup_topk on the same
    tiles: scores bit for bit, ids equal except in the order among exact
    ties (where ivf_topk takes the lower id); the first shape has fewer
    runs than k (tau -inf, pass 1 skipped), the tied one forces a rerun."""
    from repconc_tpu_torch.index.cuda_ivf import (ivf_plan, ivf_topk,
                                                  regroup_topk,
                                                  score_work_tiles,
                                                  slot_queries)

    t = _pass_tiles(cuda, Q, nlist, nprobe, Lpad, M, lut_dtype, seed=2,
                    distinct_rows=dup)
    reruns = ivf_topk.reruns
    s, i = ivf_topk(t["work_cell"], t["slot_pair"], t["lut_z"],
                    t["cell_codes"], t["cell_ids"], t["cell_len"], nprobe,
                    topk, t["scales_z"])
    scores = score_work_tiles(t["work_cell"],
                              slot_queries(t["slot_pair"], nprobe, Q),
                              t["lut_z"], t["cell_codes"], t["scales_z"])
    s_u, i_u = regroup_topk(scores.reshape(-1, Lpad), t["row"], t["cells"],
                            t["cell_ids"], Q, nprobe, topk)
    assert torch.equal(s, s_u)
    above = s > s[:, -1:]
    big = torch.iinfo(torch.long).max
    assert torch.equal(torch.sort(torch.where(above, i, big), 1).values,
                       torch.sort(torch.where(above, i_u.long(), big),
                                  1).values)
    assert bool((i[:, 1:] > i[:, :-1])[
        (s[:, 1:] == s[:, :-1]) & torch.isfinite(s[:, 1:])].all())
    assert bool((i[torch.isneginf(s)] == -1).all())
    if dup:
        assert ivf_topk.reruns == reruns + 1
    if topk == 1000 and Lpad == 256:
        assert ivf_plan(nprobe, Lpad, topk)[0] is False


def _toy_training_model(metric="METRIC_IP"):
    """A seeded toy RepCONC model (2 layers, hidden 32, M=4, K=16, dropout
    0) on the CPU."""
    from repconc_tpu_torch.core.config import EncoderConfig, RepConcConfig
    from repconc_tpu_torch.models.repconc_model import RepConcModel, init_random_

    enc = EncoderConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        max_position_embeddings=64, pooling="mean",
                        hidden_dropout=0.0, attention_dropout=0.0)
    config = RepConcConfig(encoder=enc, MCQ_M=4, MCQ_K=16,
                           similarity_metric=metric, sk_epsilon=0.05,
                           sk_iters=20)
    return init_random_(RepConcModel(config), torch.Generator().manual_seed(0))


def _toy_training_batch(rng, B=8, n_neg=2, Lq=8, Ld=12):
    ids = lambda n, L: torch.as_tensor(rng.integers(4, 64, size=(n, L)))
    pos = torch.arange(B, dtype=torch.int32)
    positives = torch.full((B, 4), -1, dtype=torch.int32)
    positives[:, 0] = pos
    return {"query_input_ids": ids(B, Lq),
            "query_attention_mask": torch.ones((B, Lq), dtype=torch.int64),
            "pos_input_ids": ids(B, Ld),
            "pos_attention_mask": torch.ones((B, Ld), dtype=torch.int64),
            "neg_input_ids": ids(B * n_neg, Ld),
            "neg_attention_mask": torch.ones((B * n_neg, Ld), dtype=torch.int64),
            "qids": pos.clone(), "pos_docids": pos, "query_positives": positives,
            "neg_docids": torch.as_tensor(
                rng.integers(B, 100, size=(B * n_neg,)).astype(np.int32))}


@pytest.mark.parametrize("metric", ["METRIC_IP", "METRIC_CENTROID_COS"])
def test_train_step_on_card_matches_cpu(cuda, metric):
    """One stage-1 step (constraint on, TF32 off) on the card and on the
    CPU from the same weights and batch: the loss within 1e-5 relative,
    each gradient within 1e-4 of its largest |g| (the centroids' gradient
    accumulates with atomics on the card), the parameters after the step
    within 1e-6, the rotation unchanged. The attention key biases, whose
    gradient is zero in exact arithmetic (tests/test_torch_stage1.py):
    gradients within 1e-6 of the largest |g| of any array. They, and the
    elements whose gradient is within the gradient bar of zero, take
    Adam's first step lr * g / (|g| + eps) with either sign: parameters
    within 2 lr there."""
    import copy

    from repconc_tpu_torch.core.device import resolve_device
    from repconc_tpu_torch.train import stage1

    dev = resolve_device("cuda")
    hp = stage1.Stage1Hparams(total_steps=10, mse_loss_weight=0.1)
    cpu = _toy_training_model(metric)
    card = copy.deepcopy(cpu).to(dev)
    batch = _toy_training_batch(np.random.default_rng(1))
    out = {}
    for name, model, device in (("cpu", cpu, "cpu"), ("card", card, dev)):
        tx = stage1.make_optimizer(hp, model)
        metrics = stage1.make_train_step(model, hp, tx)(
            {k: v.to(device) for k, v in batch.items()})
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.cpu() for n, p in model.named_parameters()})
    (m_cpu, g_cpu), (m_card, g_card) = out["cpu"], out["card"]
    for k in m_cpu:
        assert m_card[k] == pytest.approx(m_cpu[k], rel=1e-5, abs=1e-7), k
    top = max(float(g.abs().max()) for g in g_cpu.values())
    for n, g in g_cpu.items():
        bar = (1e-6 * top if n.endswith("key.bias")
               else 1e-4 * max(float(g.abs().max()), 1e-12))
        assert float((g_card[n] - g).abs().max()) <= bar, n
    card_state = card.state_dict()
    for n, a in cpu.state_dict().items():
        d = (card_state[n].cpu() - a).abs()
        if n == "rotation":
            assert float(d.max()) == 0.0
            continue
        g = g_cpu[n].abs()
        free = (torch.ones_like(g, dtype=torch.bool) if n.endswith("key.bias")
                else g <= 1e-4 * g.max())
        lr = hp.centroid_learning_rate if n == "centroids" else hp.learning_rate
        if (~free).any():
            assert float(d[~free].max()) <= 1e-6, n
        if free.any():
            assert float(d[free].max()) <= 2 * lr, n


def test_constrained_encode_on_card_matches_cpu(cuda):
    """Sinkhorn-constrained codes at the M=12 geometry (B=128, K=256,
    eps=0.003, 100 iterations) on the card and on the CPU: equal except
    where the sample's two best log Q (CPU) are within 1e-3. With fewer
    samples than centroids (B < K) the constraint splits some samples'
    mass between centroids of near-equal share: those are such ties."""
    from repconc_tpu_torch.core.device import resolve_device
    from repconc_tpu_torch.quant import codebook, sinkhorn

    dev = resolve_device("cuda")
    g = torch.Generator().manual_seed(5)
    x = torch.randn((128, 768), generator=g)
    c = torch.randn((12, 256, 64), generator=g)
    want = codebook.encode(x, c, use_constraint=True)
    got = codebook.encode(x.to(dev), c.to(dev), use_constraint=True).cpu()
    logq = sinkhorn.sinkhorn_log(
        -sinkhorn.center_distances(codebook.pairwise_sqdist(x, c)), 0.003, 100)
    top2 = logq.topk(2, dim=-1).values
    tied = (top2[..., 0] - top2[..., 1] < 1e-3).T
    assert bool((got[~tied] == want[~tied]).all())
    assert float(tied.float().mean()) < 0.25
