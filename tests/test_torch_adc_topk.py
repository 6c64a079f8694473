"""The two-pass ADC top-k (repconc_tpu_torch/index/cuda_adc.py::adc_topk)
on the CPU, where its passes take their plain versions
(index/adc.py::adc_group_max_reference, adc_filter_reference): against the
JAX package's fp32 adc_search (bf16-LUT tolerance, near-ties) and against
the port's unfused plain path (score_codes_reference + torch.topk on the
same bf16 LUT: scores bit for bit, ids equal except among exact ties). The
CUDA passes are held to the same plain versions on the card in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from repconc_tpu.index import adc as jax_adc
from repconc_tpu_torch.index import adc, cuda_adc
from repconc_tpu_torch.index.cuda_adc import (CudaADCIndex, adc_filter,
                                              adc_group_max, adc_topk,
                                              select_topk)
from test_torch_adc import _bf16_tol, _exact_scores, _problem, assert_same_topk


def _tied_problem(seed, Q, N, distinct, M=8, K=32, dsub=4):
    """Only `distinct` code rows, repeated through the corpus: every score
    is shared by about N / distinct docs, so exact ties sit at tau."""
    q, c, codes = _problem(seed, Q, distinct, M, K, dsub)
    return q, c, np.tile(codes, (-(-N // distinct), 1))[:N]


def _bf16_lut(q, c):
    lut = adc.build_lut(torch.from_numpy(q), torch.from_numpy(c))
    return lut.to(torch.bfloat16).contiguous()


def _assert_equals_unfused(s, i, lut, codes, n_valid, topk):
    """Scores bit-equal to a torch.topk over the plain scores, each id
    carrying its own plain score, ties in id order."""
    scores = adc.score_codes_reference(lut, codes[:n_valid])
    want, _ = torch.topk(scores, min(topk, n_valid), dim=1)
    assert torch.equal(s, want)
    assert torch.equal(torch.gather(scores, 1, i), s)
    tie = s[:, 1:] == s[:, :-1]
    assert bool((i[:, 1:] > i[:, :-1])[tie].all())


CASES = {  # Q, N, topk, distinct code rows (0: all random), GROUPS_MAX
    "topk_below_n": (6, 9000, 40, 0, None),
    "topk_equals_n": (5, 700, 700, 0, None),
    "topk_above_n": (3, 90, 200, 0, None),
    "n_not_multiple_of_g": (4, 20_011, 25, 0, 97),
    "ragged_q": (13, 6000, 30, 0, None),
    "ties_force_rerun": (5, 12_000, 20, 30, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_index_cpu_path_matches_jax_adc_search(case, monkeypatch):
    """CudaADCIndex on the CPU (the passes' plain versions, pad rows from
    chunk_size present) against JAX's fp32 adc_search: ids equal except
    near-ties within the bf16-LUT tolerance, scores within it."""
    Q, N, topk, distinct, groups = CASES[case]
    if groups:
        monkeypatch.setattr(cuda_adc, "GROUPS_MAX", groups)
    if distinct:
        q, c, codes = _tied_problem(10, Q, N, distinct)
    else:
        q, c, codes = _problem(10, Q, N)
    s_ref, i_ref = jax_adc.adc_search(q, codes, c, topk=topk)
    index = CudaADCIndex(codes, c, chunk_size=512, device="cpu")
    assert index.codes.shape[0] % index.chunk == 0
    assert index.codes.shape[0] > N or N <= 512 or N % 512 == 0
    reruns = adc_topk.reruns
    lut = _bf16_lut(q, c)
    s, i = adc_topk(lut, index.codes, N, topk)
    assert adc_topk.reruns == reruns + (1 if distinct else 0)
    s_idx, i_idx = index.search(q, topk=topk)
    np.testing.assert_array_equal(s.numpy(), s_idx)
    np.testing.assert_array_equal(i.numpy(), i_idx)
    assert s_idx.shape == s_ref.shape == (Q, min(topk, N))
    assert np.isfinite(s_idx).all() and (i_idx < N).all()
    exact, lut64 = _exact_scores(q, c, codes)
    tol = _bf16_tol(lut64)
    assert_same_topk(i_idx, np.asarray(i_ref), exact, tol)
    assert (np.abs(s_idx - np.asarray(s_ref)) <= tol[:, None]).all()


@pytest.mark.parametrize("case", list(CASES))
def test_topk_equals_unfused_plain_path(case, monkeypatch):
    """adc_topk over padded codes against score_codes_reference + torch.topk
    on the same bf16 LUT: scores bit for bit, ids except exact ties."""
    Q, N, topk, distinct, groups = CASES[case]
    if groups:
        monkeypatch.setattr(cuda_adc, "GROUPS_MAX", groups)
    if distinct:
        q, c, codes = _tied_problem(11, Q, N, distinct)
    else:
        q, c, codes = _problem(11, Q, N)
    padded = torch.from_numpy(np.concatenate(
        [codes, np.zeros((37, codes.shape[1]), np.uint8)]))
    lut = _bf16_lut(q, c)
    s, i = adc_topk(lut, padded, N, topk)
    _assert_equals_unfused(s, i, lut, padded, N, topk)


@pytest.mark.parametrize("Q,N,groups", [(4, 5000, 64), (7, 3333, 100),
                                        (2, 100_000, 2048), (3, 64, 5)])
def test_tau_never_above_kth_score(Q, N, groups):
    """tau, the k-th largest group max, is at most the k-th best score, so
    at least k docs pass pass 2; groups interleave runs of 32 docs."""
    q, c, codes = _problem(12, Q, N)
    lut = _bf16_lut(q, c)
    codes = torch.from_numpy(codes)
    gmax = adc_group_max(lut, codes, N, groups)
    scores = adc.score_codes_reference(lut, codes)
    group = (torch.arange(N) // 32) % groups
    for g in range(groups):
        members = scores[:, group == g]
        want = members.max(1).values if members.shape[1] else torch.full(
            (Q,), -torch.inf)
        assert torch.equal(gmax[:, g], want)
    for k in (1, min(groups, 10), min(groups, N)):
        tau = torch.topk(gmax, k, dim=1).values[:, -1]
        kth = torch.topk(scores, k, dim=1).values[:, -1]
        assert bool((tau <= kth).all())
        _, _, count = adc_filter(lut, codes, N, tau.contiguous(), 1)
        assert bool((count >= k).all())


@pytest.mark.parametrize("cap", [1, 7, 400])
def test_filter_reference_layout_and_counts(cap):
    """adc_filter's plain version: count[q] docs pass; the first
    min(count, cap) of them in id order fill the first slots, the rest hold
    -inf and -1; pad rows past n_valid never pass."""
    q, c, codes = _problem(13, 5, 300)
    lut = _bf16_lut(q, c)
    codes = torch.from_numpy(np.concatenate([codes, codes[:20]]))
    scores = adc.score_codes_reference(lut, codes[:300])
    tau = torch.quantile(scores, 0.9, dim=1).contiguous()
    cand_s, cand_i, count = adc_filter(lut, codes, 300, tau, cap)
    assert cand_s.shape == cand_i.shape == (5, cap)
    for r in range(5):
        ids = torch.nonzero(scores[r] >= tau[r]).flatten()
        assert int(count[r]) == ids.numel()
        n = min(ids.numel(), cap)
        assert torch.equal(cand_i[r, :n], ids[:n])
        assert torch.equal(cand_s[r, :n], scores[r, ids[:n]])
        assert bool((cand_i[r, n:] == -1).all())
        assert bool(torch.isneginf(cand_s[r, n:]).all())


def test_select_topk_ignores_candidate_order():
    """The final selection sorts by (score DESC, id ASC), whatever order
    pass 2 stored the candidates in."""
    g = torch.Generator().manual_seed(0)
    s = torch.randint(0, 4, (3, 12), generator=g).float()
    i = torch.stack([torch.randperm(12, generator=g) for _ in range(3)])
    s[:, -2:], i[:, -2:] = -torch.inf, -1
    top_s, top_i = select_topk(s, i, 6)
    for r in range(3):
        perm = torch.randperm(12, generator=g)
        again_s, again_i = select_topk(s[r:r + 1, perm], i[r:r + 1, perm], 6)
        assert torch.equal(again_s[0], top_s[r])
        assert torch.equal(again_i[0], top_i[r])
        pairs = sorted(zip((-s[r]).tolist(), i[r].tolist()))[:6]
        assert top_i[r].tolist() == [d for _, d in pairs]


def test_spill_merge_takes_the_two_pass_search(monkeypatch):
    """merge_spill (the IVF spill) on the CPU goes through adc_topk: the
    merged top-k equals a top-k over the cells' candidates and the spill's
    plain scores."""
    from repconc_tpu_torch.index.cuda_ivf import merge_spill

    q, c, codes = _problem(14, 6, 3000)
    spill = CudaADCIndex(codes, c, device="cpu")
    spill_ids = torch.arange(3000) + 10_000
    cell_s = torch.randn((6, 50), generator=torch.Generator().manual_seed(1))
    cell_i = torch.randint(0, 10_000, (6, 50))
    calls = []
    monkeypatch.setattr(cuda_adc, "adc_topk",
                        lambda *a: calls.append(a[2:]) or adc_topk(*a))
    s, i = merge_spill(cell_s, cell_i, spill, spill_ids,
                       torch.from_numpy(q), 50)
    assert calls == [(3000, 50)]
    lut = _bf16_lut(q, c)
    plain = adc.score_codes_reference(lut, torch.from_numpy(codes))
    want, _ = torch.topk(torch.cat([cell_s, plain], 1), 50, dim=1)
    assert torch.equal(s, want)
    from_spill = i >= 10_000
    assert torch.equal(
        torch.gather(plain, 1, (i - 10_000).clamp(min=0))[from_spill],
        s[from_spill])


@pytest.mark.parametrize("where", ["meta", "mixed"])
@pytest.mark.parametrize("kernel", ["adc_group_max", "adc_filter"])
def test_pass_wrappers_raise_instead_of_falling_back(kernel, where):
    """The passes take their plain versions only for CPU tensors; a tensor
    they cannot launch on raises and counts no launch."""
    lut = torch.zeros((4, 8, 32), dtype=torch.bfloat16)
    codes = torch.zeros((70, 8), dtype=torch.uint8)
    tau = torch.zeros(4)
    fn = adc_group_max if kernel == "adc_group_max" else adc_filter
    args = [lut, codes, 64, 3] if fn is adc_group_max else [lut, codes, 64,
                                                           tau, 5]
    before = fn.launches
    fn(*args)  # CPU tensors: the plain version, no launch
    assert fn.launches == before
    if where == "meta":
        args[0], args[1] = lut.to("meta"), codes.to("meta")
        if fn is adc_filter:
            args[3] = tau.to("meta")
    else:
        args[1] = codes.to("meta")
    with pytest.raises(ValueError):
        fn(*args)
    assert fn.launches == before


@pytest.mark.parametrize("bad", ["n_valid_past_codes", "fp32_lut",
                                 "tau_shape", "gmax_rows", "cap_zero",
                                 "groups_zero"])
def test_pass_wrappers_reject_what_they_cannot_take(bad):
    lut = torch.zeros((4, 8, 32), dtype=torch.bfloat16)
    codes = torch.zeros((70, 8), dtype=torch.uint8)
    tau, gmax, n_valid, cap, groups = torch.zeros(4), None, 64, 5, 3
    if bad == "n_valid_past_codes":
        n_valid = 71
    elif bad == "fp32_lut":
        lut = lut.float()
    elif bad == "tau_shape":
        tau = torch.zeros(5)
    elif bad == "gmax_rows":
        gmax = torch.zeros((3, 3))
    elif bad == "cap_zero":
        cap = 0
    else:
        groups = 0
    with pytest.raises((TypeError, ValueError)):
        if bad == "groups_zero":
            adc_group_max(lut, codes, n_valid, groups)
        else:
            adc_filter(lut, codes, n_valid, tau, cap, gmax)
