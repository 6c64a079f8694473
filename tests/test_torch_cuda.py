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
