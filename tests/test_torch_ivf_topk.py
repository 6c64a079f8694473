"""The two-pass IVF search (repconc_tpu_torch/index/cuda_ivf.py::ivf_topk)
on the CPU, where its passes take their plain versions
(ivf_group_max_reference, ivf_filter_reference): against the port's
unfused plain path (score_work_tiles_reference + regroup_topk on the same
tiles and LUT: scores bit for bit, ids equal except in the order among
exact ties) and against the JAX package's serve_search(mode="pallas") in
Pallas interpret mode (tests/test_torch_ivf.py's tolerance and near-tie
rule). The CUDA passes are held to the same plain versions on the card in
tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from repconc_tpu.index import ivf as jax_ivf
from repconc_tpu_torch.index import cuda_ivf, ivf
from repconc_tpu_torch.index.adc import RUN
from repconc_tpu_torch.index.cuda_ivf import (ivf_filter, ivf_filter_reference,
                                              ivf_group_max,
                                              ivf_group_max_reference,
                                              ivf_plan, ivf_topk, make_lut_z,
                                              regroup_topk,
                                              score_work_tiles_reference,
                                              slot_queries)
from test_torch_ivf import _assert_ids_near_ties, _port_index, _resum


def _problem(seed, Q, nlist, nprobe, Lpad, M=8, K=32, lens=None, cells=None,
             lut_dtype="bf16", distinct=0):
    """Tiles over random distinct cells per query, each cell filled to its
    length with consecutive corpus ids and trailing pads (id -1), random
    codes (pads too: they have real scores), and the (Q + 1) LUT; with
    `distinct`, every cell repeats the same `distinct` code rows."""
    rng = np.random.default_rng(seed)
    if cells is None:
        cells = np.stack([rng.choice(nlist, nprobe, replace=False)
                          for _ in range(Q)])
    if lens is None:
        lens = rng.integers(0, Lpad + 1, nlist)
    ids = np.full((nlist, Lpad), -1, np.int32)
    real = np.arange(Lpad)[None, :] < np.asarray(lens)[:, None]
    ids[real] = np.arange(real.sum())
    codes = rng.integers(0, K, (nlist, Lpad, M)).astype(np.uint8)
    if distinct:
        codes[:] = np.resize(codes[0, :distinct], (Lpad, M))
    q = rng.normal(size=(Q, M * 4)).astype(np.float32)
    cent = rng.normal(size=(M, K, 4)).astype(np.float32)
    cells = torch.from_numpy(np.asarray(cells))
    row, work_cell, slot_pair = cuda_ivf.group_pairs(cells, Q, nlist, nprobe)
    lut_z, scales_z = make_lut_z(torch.from_numpy(q), torch.from_numpy(cent),
                                 lut_dtype)
    cell_ids = torch.from_numpy(ids)
    return dict(cells=cells, row=row, work_cell=work_cell,
                slot_pair=slot_pair, lut_z=lut_z, scales_z=scales_z,
                cell_codes=torch.from_numpy(codes), cell_ids=cell_ids,
                cell_len=cuda_ivf.cell_lengths(cell_ids), nprobe=nprobe, Q=Q)


def _unfused(p, topk):
    """K2 / K3's plain version and regroup_topk: the search before the
    passes. Returns (scores, ids, every candidate's score, their ids)."""
    Q, nprobe, Lpad = p["Q"], p["nprobe"], p["cell_codes"].shape[1]
    scores = score_work_tiles_reference(
        p["work_cell"], slot_queries(p["slot_pair"], nprobe, Q), p["lut_z"],
        p["cell_codes"], p["scales_z"])
    flat = scores.reshape(-1, Lpad)
    s, i = regroup_topk(flat, p["row"], p["cells"], p["cell_ids"], Q, nprobe,
                        topk)
    cand = flat[p["row"]].reshape(Q, -1)
    cand_ids = p["cell_ids"][p["cells"].reshape(-1).long()].reshape(Q, -1)
    return s, i.long(), cand, cand_ids.long()


def _search(p, topk):
    return ivf_topk(p["work_cell"], p["slot_pair"], p["lut_z"],
                    p["cell_codes"], p["cell_ids"], p["cell_len"],
                    p["nprobe"], topk, p["scales_z"])


def assert_equals_unfused(s, i, p, topk):
    """Scores bit-equal to the unfused path's; every returned id a real doc
    of a probed cell carrying its own plain score; the ids above the cut
    equal as sets; exact ties in id order; -inf only with id -1."""
    s_u, i_u, cand, cand_ids = _unfused(p, topk)
    assert torch.equal(s, s_u)
    finite = torch.isfinite(s)
    assert bool((i[~finite] == -1).all()) and bool((i[finite] >= 0).all())
    for r in range(s.shape[0]):
        for score, doc in zip(s[r][finite[r]].tolist(),
                              i[r][finite[r]].tolist()):
            pos = torch.nonzero(cand_ids[r] == doc).flatten()
            assert pos.numel() == 1 and cand[r, pos[0]].item() == score
    above = s > s[:, -1:]
    big = torch.iinfo(torch.long).max
    assert torch.equal(torch.sort(torch.where(above, i, big), 1).values,
                       torch.sort(torch.where(above, i_u, big), 1).values)
    tie = (s[:, 1:] == s[:, :-1]) & finite[:, 1:]
    assert bool((i[:, 1:] > i[:, :-1])[tie].all())


CASES = {  # Q, nlist, nprobe, Lpad, topk; pass 1 runs; pass 2 reruns
    "tau_finite": (20, 8, 3, 1024, 5, True, False),
    "tau_neg_inf": (20, 8, 3, 256, 50, False, False),
    "forced_rerun": (12, 8, 3, 256, 10, True, True),
    "empty_slots": (5, 16, 4, 100, 4, True, None),
    "pad_above_real": (3, 4, 2, 64, 3, True, None),
    "query_with_empty_cells": (6, 8, 2, 128, 5, True, None),
}


def _case(name, lut_dtype, seed=0):
    Q, nlist, nprobe, Lpad, topk = CASES[name][:5]
    kw = dict(lut_dtype=lut_dtype)
    if name == "forced_rerun":
        kw["distinct"] = 1  # one code row everywhere: every doc ties
    if name == "pad_above_real":
        kw["lens"] = [40, 5, 33, 17]  # partial runs: pads share a run
        kw["cells"] = [[0, 2], [1, 3], [2, 0]]
    if name == "query_with_empty_cells":
        kw["lens"] = [0, 0, 90, 128, 7, 60, 33, 100]
        kw["cells"] = [[0, 1], [1, 2], [3, 4], [5, 6], [7, 0], [2, 3]]
    p = _problem(seed + len(name), Q, nlist, nprobe, Lpad, **kw)
    if name == "pad_above_real":
        # every pad takes query 0's best code of each m: it outscores every
        # real doc of its run for query 0
        best = p["lut_z"][0].float().argmax(1).to(torch.uint8)
        p["cell_codes"][p["cell_ids"] < 0] = best
    return p, topk


@pytest.mark.parametrize("lut_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_ivf_topk_equals_unfused_plain_path(case, lut_dtype):
    p, topk = _case(case, lut_dtype)
    Lpad = p["cell_codes"].shape[1]
    pass1, rerun = CASES[case][5:]
    assert ivf_plan(p["nprobe"], Lpad, topk)[0] == pass1
    if case == "empty_slots":
        assert bool((p["slot_pair"] < 0).any())
    reruns = ivf_topk.reruns
    s, i = _search(p, topk)
    if rerun is not None:
        assert ivf_topk.reruns == reruns + rerun
    assert s.shape == i.shape == (p["Q"], min(topk, p["nprobe"] * Lpad))
    assert_equals_unfused(s, i, p, topk)
    if case == "query_with_empty_cells":
        assert bool(torch.isneginf(s[0]).all()) and bool((i[0] == -1).all())
    if case == "pad_above_real":
        _, _, cand, cand_ids = _unfused(p, topk)
        assert bool(cand[0][cand_ids[0] < 0].max() > s[0].max())


@pytest.mark.parametrize("Q,nlist,nprobe,Lpad,M,K", [
    (20, 8, 3, 256, 8, 32), (9, 6, 2, 100, 12, 256), (33, 4, 4, 64, 4, 32)])
@pytest.mark.parametrize("lut_dtype", ["bf16", "int8"])
def test_group_max_is_the_run_max_without_pads(Q, nlist, nprobe, Lpad, M, K,
                                               lut_dtype):
    """Pass 1's plain version: for every pair, the max over each run of 32
    docs of the plain K2 / K3 scores of its cell, pads excluded, -inf for a
    run with no real doc; the wrapper takes it for CPU tensors and counts
    no launch."""
    p = _problem(Q + Lpad, Q, nlist, nprobe, Lpad, M, K, lut_dtype=lut_dtype)
    args = (p["work_cell"], p["slot_pair"], p["lut_z"], p["cell_codes"],
            p["cell_len"], nprobe, p["scales_z"])
    gmax = ivf_group_max_reference(*args)
    R = -(-Lpad // RUN)
    assert gmax.shape == (Q, nprobe, R)
    _, _, cand, cand_ids = _unfused(p, 1)
    cand = cand.reshape(Q, nprobe, Lpad)
    real = cand_ids.reshape(Q, nprobe, Lpad) >= 0
    for r in range(R):
        docs = slice(r * RUN, (r + 1) * RUN)
        want = torch.where(real[:, :, docs], cand[:, :, docs],
                           -torch.inf).amax(-1)
        assert torch.equal(gmax[:, :, r], want)
    before = repr(ivf_group_max.launches)
    assert torch.equal(ivf_group_max(*args), gmax)
    assert repr(ivf_group_max.launches) == before


@pytest.mark.parametrize("cap", [1, 7, 400])
@pytest.mark.parametrize("lut_dtype", ["bf16", "int8"])
def test_filter_reference_keeps_exactly_the_docs_above_tau(cap, lut_dtype):
    """Pass 2's plain version: count[q] is the number of real docs of the
    query's probed cells scoring >= tau[q]; the first min(count, cap) of
    them, in pair then doc order, fill the first slots with their corpus
    ids and scores; nothing is stored past cap (-inf, id -1 there)."""
    p = _problem(5, 10, 8, 3, 256, lut_dtype=lut_dtype)
    _, _, cand, cand_ids = _unfused(p, 1)
    real = cand_ids >= 0
    tau = torch.quantile(torch.where(real, cand, torch.nan).nan_to_num(
        -1e9), 0.97, dim=1).contiguous()
    tau[3] = -torch.inf  # every real doc passes
    args = (p["work_cell"], p["slot_pair"], p["lut_z"], p["cell_codes"],
            p["cell_ids"], p["cell_len"], p["nprobe"], tau, cap)
    cand_s, cand_i, count = ivf_filter_reference(*args, p["scales_z"])
    assert cand_s.shape == cand_i.shape == (10, cap)
    for r in range(10):
        hit = real[r] & (cand[r] >= tau[r])
        assert int(count[r]) == int(hit.sum())
        n = min(int(hit.sum()), cap)
        assert torch.equal(cand_i[r, :n], cand_ids[r][hit][:n])
        assert torch.equal(cand_s[r, :n], cand[r][hit][:n])
        assert bool((cand_i[r, n:] == -1).all())
        assert bool(torch.isneginf(cand_s[r, n:]).all())
    assert int(count[3]) == int(real[3].sum())
    before = repr(ivf_filter.launches)
    again = ivf_filter(*args, None, p["scales_z"])
    assert all(torch.equal(a, b) for a, b in zip(again, (cand_s, cand_i,
                                                          count)))
    assert repr(ivf_filter.launches) == before


def test_cell_lengths_needs_trailing_pads():
    """The passes take docs 0 .. len - 1 as a cell's real ones; an index
    with a pad before a real doc is refused where it is loaded."""
    ids = torch.tensor([[0, 1, -1, -1], [-1, -1, -1, -1], [2, 3, 4, 5]],
                       dtype=torch.int32)
    assert cuda_ivf.cell_lengths(ids).tolist() == [2, 0, 4]
    ids[0, 2], ids[0, 1] = 1, -1
    with pytest.raises(ValueError):
        cuda_ivf.cell_lengths(ids)


@pytest.fixture(scope="module")
def built():
    from test_torch_ivf import _clustered_index

    return _clustered_index(3)


@pytest.fixture(scope="module")
def spilled():
    from test_torch_ivf import _clustered_index

    index, *rest = _clustered_index(5, M=8, pad_quantile=0.3)
    return (index, *rest)


@pytest.mark.parametrize("which", ["built", "spilled"])
@pytest.mark.parametrize("lut_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("topk,nprobe", [(10, 8), (150, 2)])
def test_serve_search_fused_matches_jax_interpret(which, lut_dtype, topk,
                                                  nprobe, request,
                                                  monkeypatch):
    """serve_search(mode="pallas") through ivf_topk (pass 1 and a finite
    tau at topk=10, nprobe=8; tau -inf and pass 1 skipped at topk=150,
    nprobe=2) against JAX's interpret-mode kernels and regroup, with and
    without a spill: scores rank for rank to 1e-5, ids equal except
    near-ties, every score the port's own plain re-sum; the unfused scan is
    not called."""
    index, _, _, _, queries = request.getfixturevalue(which)
    port = _port_index(index)
    Lpad = port.Lpad
    calls = []
    monkeypatch.setattr(cuda_ivf, "ivf_group_max",
                        lambda *a: calls.append("pass1")
                        or ivf_group_max(*a))
    monkeypatch.setattr(cuda_ivf, "score_work_tiles", None)
    got_s, got_i = ivf.serve_search(port, queries, topk=topk, nprobe=nprobe,
                                    mode="pallas", lut_dtype=lut_dtype,
                                    search_batch=20, device="cpu")
    pass1 = ivf_plan(nprobe, Lpad, topk)[0]
    assert bool(calls) == pass1 and pass1 == (topk == 10)
    want_s, want_i = jax_ivf.serve_search(index, queries, topk=topk,
                                          nprobe=nprobe, mode="pallas",
                                          lut_dtype=lut_dtype,
                                          search_batch=20)
    finite = np.isfinite(want_s)
    assert (np.isfinite(got_s) == finite).all()
    _assert_ids_near_ties(np.where(finite, got_i, -1),
                          np.where(finite, want_i, -1),
                          np.where(finite, got_s, 0), np.where(finite, want_s, 0),
                          1e-5)
    resum = _resum(port, queries, got_i, lut_dtype)
    np.testing.assert_allclose(got_s[finite], resum[finite], rtol=1e-5,
                               atol=1e-5)
