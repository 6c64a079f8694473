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
