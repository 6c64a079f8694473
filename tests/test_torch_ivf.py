"""The port's IVF-PQ (repconc_tpu_torch/index/{ivf,cuda_ivf}.py) against
repconc_tpu/index/{ivf,pallas_ivf}.py on numpy-seeded inputs, on the CPU.
JAX's Pallas kernels run in interpret mode, as tests/test_ivf.py runs
them; the port's kernels K1 / K2 / K3 / K4 take their plain versions here and
are held to them on the card by tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repconc_tpu.index import ivf as jax_ivf
from repconc_tpu.index import pallas_adc as jax_padc
from repconc_tpu.index import pallas_ivf as jax_pivf
from repconc_tpu.index.kmeans import pq_encode_chunked, pq_fit
from repconc_tpu_torch import build
from repconc_tpu_torch.index import adc, cuda_ivf, ivf
from repconc_tpu_torch.index.cuda_adc import adc_scores_int8
from repconc_tpu_torch.recipes import bench_k4


def _clustered_index(seed, N=3000, D=32, M=4, K=32, nlist=16,
                     pad_quantile=0.995, Q=32):
    """A JAX-built index over a clustered corpus, as tests/test_ivf.py
    builds them, with its embeddings, codes, codebook and queries."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(24, D)).astype(np.float32) * 2
    embeds = (centers[rng.integers(0, 24, N)]
              + rng.normal(size=(N, D)).astype(np.float32) * 0.3)
    cent, _ = pq_fit(jnp.asarray(embeds[:1500]), M=M, K=K, iters=8)
    cent = np.asarray(cent)
    codes = pq_encode_chunked(embeds, jnp.asarray(cent), chunk=1024)
    index = jax_ivf.build_ivf(embeds, codes, cent, nlist=nlist, kmeans_iters=6,
                              pad_quantile=pad_quantile)
    queries = (embeds[rng.integers(0, N, Q)]
               + rng.normal(size=(Q, D)).astype(np.float32) * 0.1)
    return index, embeds, codes, cent, queries


@pytest.fixture(scope="module")
def built():
    return _clustered_index(3)


@pytest.fixture(scope="module")
def spilled():
    """M=8 and a low pad quantile: a spill segment of some docs."""
    index, *rest = _clustered_index(5, M=8, pad_quantile=0.3)
    assert len(index.spill_ids) > 0
    return (index, *rest)


def _port_index(jax_index):
    return ivf.IVFIndex(**{f: np.asarray(getattr(jax_index, f))
                           for f in jax_index.__dataclass_fields__})


def _resum(index, queries, ids, lut_dtype):
    """The plain re-sum of each returned id's codes with the port's LUT:
    the int8 LUT for a cell's doc when lut_dtype is int8, else (and always
    for a spill doc, which K1 scans) the bf16 LUT."""
    codes = np.zeros((index.ntotal, index.cell_codes.shape[2]), np.uint8)
    ok = index.cell_ids >= 0
    codes[index.cell_ids[ok]] = index.cell_codes[ok]
    codes[index.spill_ids] = index.spill_codes
    lut = adc.build_lut(torch.from_numpy(queries),
                        torch.from_numpy(index.centroids))
    picked = torch.from_numpy(codes[np.maximum(ids, 0)]).long()  # (Q, k, M)
    lut_bf16 = lut.to(torch.bfloat16).float()
    out = torch.zeros(picked.shape[:2])
    for m in range(picked.shape[2]):
        out += torch.gather(lut_bf16[:, m], 1, picked[:, :, m])
    if lut_dtype != "int8":
        return out.numpy()
    Q, M, K = lut.shape
    lut_i8, scales = adc.quantize_lut_int8(lut, adc.group_size(M, K))
    i8 = torch.stack([adc.score_codes_int8_reference(
        lut_i8[r:r + 1], scales[r:r + 1], torch.from_numpy(
            codes[np.maximum(ids[r], 0)]))[0] for r in range(Q)])
    return np.where(np.isin(ids, index.spill_ids), out.numpy(), i8.numpy())


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)])


def _assert_ids_near_ties(ids_a, ids_b, s_a, s_b, tol):
    """Rank-wise scores within tol, and a doc in one top-k but not the
    other only where its score ties (within tol) with the cut."""
    np.testing.assert_allclose(s_a, s_b, rtol=tol, atol=tol)
    for r in range(len(ids_a)):
        a, b = list(ids_a[r]), list(ids_b[r])
        for d in set(a) ^ set(b):
            s_d = s_a[r, a.index(d)] if d in a else s_b[r, b.index(d)]
            assert abs(s_d - s_a[r, -1]) <= tol, (r, d)


# ---- build ------------------------------------------------------------

@pytest.mark.parametrize("which", ["built", "spilled"])
def test_fill_matches_jax_given_its_coarse_centroids(which, request):
    """Given JAX's coarse centroids, the port's assignment and fill give
    equal lists, sizes, spill segment and Lpad."""
    index, embeds, codes, _, _ = request.getfixturevalue(which)
    pad_quantile = 0.995 if which == "built" else 0.3
    cells = ivf.assign_cells(embeds, torch.tensor(index.coarse_centroids),
                             assign_chunk=1000)
    got = ivf.fill_cells(cells, codes, index.nlist, pad_quantile)
    want = (index.cell_codes, index.cell_ids, index.cell_sizes,
            index.spill_codes, index.spill_ids)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_build_ivf_from_codes_covers_every_doc(built):
    """The port's own build (its k-means draws differ from JAX's): every
    doc once in a cell or the spill, codes stored faithfully, Lpad a
    multiple of 128, and full probe equal to flat ADC."""
    _, _, codes, cent, queries = built
    index = ivf.build_ivf_from_codes(codes, cent, nlist=16, kmeans_iters=6,
                                     device="cpu")
    assert index.ntotal == len(codes) and index.Lpad % 128 == 0
    ids = np.concatenate([index.cell_ids[index.cell_ids >= 0], index.spill_ids])
    assert sorted(ids.tolist()) == list(range(len(codes)))
    ok = index.cell_ids >= 0
    np.testing.assert_array_equal(index.cell_codes[ok], codes[index.cell_ids[ok]])
    s_ivf, _ = ivf.search_xla(index, queries, topk=10, nprobe=16, device="cpu")
    s_flat, _ = adc.adc_search(queries, codes, cent, topk=10, device="cpu")
    np.testing.assert_allclose(s_ivf, s_flat, rtol=1e-5, atol=1e-5)


def test_build_ivf_balanced_raises(built):
    """The balanced build is ported: it covers every doc once and stores
    the codes faithfully (tests/test_torch_ivf_decoded.py holds it to the
    JAX package's)."""
    _, embeds, codes, cent, _ = built
    index = ivf.build_ivf(embeds, codes, cent, nlist=4, balanced=True,
                          device="cpu")
    assert index.nlist == 4 and index.ntotal == len(codes)
    ids = np.concatenate([index.cell_ids[index.cell_ids >= 0],
                          index.spill_ids])
    assert sorted(ids.tolist()) == list(range(len(codes)))
    ok = index.cell_ids >= 0
    np.testing.assert_array_equal(index.cell_codes[ok],
                                  codes[index.cell_ids[ok]])


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_ivf_index_npz_loads_both_ways(built, tmp_path, writer):
    index = built[0]
    if writer == "jax":
        index.save(str(tmp_path))
        loaded = ivf.IVFIndex.load(str(tmp_path))
    else:
        _port_index(index).save(str(tmp_path))
        loaded = jax_ivf.IVFIndex.load(str(tmp_path))
    assert not (tmp_path / "ivf_index.tmp.npz").exists()
    for f in index.__dataclass_fields__:
        got, want = getattr(loaded, f), getattr(index, f)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---- probing and grouping ------------------------------------------------

@pytest.mark.parametrize("nprobe", [1, 4, 16])
def test_probe_cells_matches_jax(built, nprobe):
    """Equal cells except near-ties at the nprobe boundary."""
    index, _, _, _, queries = built
    want = np.asarray(jax_ivf.probe_cells(
        jnp.asarray(queries), jnp.asarray(index.coarse_centroids), nprobe))
    got = ivf.probe_cells(torch.from_numpy(queries),
                          torch.from_numpy(index.coarse_centroids),
                          nprobe).numpy()
    c = index.coarse_centroids.astype(np.float64)
    score = queries.astype(np.float64) @ c.T - 0.5 * (c ** 2).sum(-1)
    for r in range(len(queries)):
        for cell in set(got[r]) ^ set(want[r]):
            assert abs(score[r, cell] - np.sort(score[r])[-nprobe]) <= 1e-4


def _cells(seed, Q, nlist, nprobe):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(nlist, nprobe, replace=False)
                     for _ in range(Q)]).astype(np.int32)


def _at_budget(row, work_cell, slot_pair, Q, nprobe, T_max):
    """What JAX's _group_pairs returns at a static budget of T_max tiles,
    derived from the port's exact grid: the same rows; the first T_max
    tiles' cells and slot queries, unused tiles at cell 0 and query Q; and
    the overflow, the pairs whose tile falls past T_max (dropped)."""
    T = work_cell.shape[0]
    n = min(T, T_max)
    wc = np.zeros(T_max, np.int32)
    wc[:n] = work_cell.numpy()[:n]
    qidx = np.full((T_max, cuda_ivf.QT_G), Q, np.int32)
    qidx[:n] = cuda_ivf.slot_queries(slot_pair, nprobe, Q).numpy()[:n]
    overflow = int((row.numpy() // cuda_ivf.QT_G >= T_max).sum())
    return row.numpy(), wc, qidx, overflow


@pytest.mark.parametrize("Q,nlist,nprobe,factor", [
    (64, 32, 4, 1.35), (64, 16, 8, 1.35), (40, 32, 32, 1.35),
    (64, 16, 4, 0.01)])  # the last forces an overflow
def test_group_pairs_matches_jax(Q, nlist, nprobe, factor):
    """At JAX's own _tile_budget T_max, the port's exact grouping, cut to
    that budget, gives JAX's rows, tile cells, slot queries and overflow
    count."""
    cells = _cells(Q + nlist, Q, nlist, nprobe)
    T_max = jax_pivf._tile_budget(Q, nprobe, nlist, factor)
    _, want_row, want_wc, want_qidx, want_ov = jax_pivf._group_pairs(
        jnp.asarray(cells), Q, nlist, nprobe, T_max)
    row, wc, qidx, ov = _at_budget(*cuda_ivf.group_pairs(
        torch.from_numpy(cells), Q, nlist, nprobe), Q, nprobe, T_max)
    np.testing.assert_array_equal(row, np.asarray(want_row))
    np.testing.assert_array_equal(wc, np.asarray(want_wc))
    np.testing.assert_array_equal(qidx, np.asarray(want_qidx))
    assert ov == int(want_ov)
    if factor < 1:
        assert ov > 0


@pytest.mark.parametrize("Q,nlist,nprobe", [(64, 32, 4), (64, 16, 8), (1, 8, 1)])
def test_exact_tile_grid_is_what_jax_occupies(Q, nlist, nprobe):
    """The exact grid has the tiles JAX's grouping occupies at its
    worst-case budget, with its slot queries; every pair has one slot, and
    slot_pair maps each slot row back to its pair."""
    cells = _cells(Q * 3 + nlist, Q, nlist, nprobe)
    T_worst = Q * nprobe // cuda_ivf.QT_G + nlist + 1
    *_, want_qidx, _ = jax_pivf._group_pairs(jnp.asarray(cells), Q, nlist,
                                             nprobe, T_worst)
    occupied = int((np.asarray(want_qidx) != Q).any(1).sum())
    row, wc, slot_pair = cuda_ivf.group_pairs(torch.from_numpy(cells), Q,
                                              nlist, nprobe)
    assert wc.shape[0] == occupied and slot_pair.shape == (occupied,
                                                           cuda_ivf.QT_G)
    np.testing.assert_array_equal(
        cuda_ivf.slot_queries(slot_pair, nprobe, Q).numpy(),
        np.asarray(want_qidx)[:occupied])
    np.testing.assert_array_equal(slot_pair.reshape(-1)[row].numpy(),
                                  np.arange(Q * nprobe))
    assert int((slot_pair >= 0).sum()) == Q * nprobe


# ---- quantization and the plain scorers ----------------------------------

# quantize_lut_int8 as every JAX caller runs it: inside jit, where XLA
# computes amax / 127.0 as amax * fp32(1 / 127)
jax_quantize_lut_int8 = jax.jit(jax_padc.quantize_lut_int8,
                                static_argnums=(1, 2))


def _assert_quantize_matches_jax(lut, M, K):
    """The port's int8 LUT and scales bit-equal to JAX's jitted ones."""
    Q = lut.shape[0]
    gm = adc.group_size(M, K)
    assert gm == jax_padc._group_size(M, K)
    want_q, want_s = jax_quantize_lut_int8(
        jax_padc.permute_lut(jnp.asarray(lut), gm), gm, K)
    got_q, got_s = adc.quantize_lut_int8(torch.from_numpy(lut), gm)
    # undo the TPU's k-major lane order: (Q, G, K, gm) -> (Q, M, K)
    want_q = np.asarray(want_q).reshape(Q, M // gm, K, gm).transpose(
        0, 1, 3, 2).reshape(Q, M, K)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_q.numpy(), want_q)


@pytest.mark.parametrize("M,K", [(4, 32), (8, 32), (12, 256)])
def test_quantize_lut_int8_matches_jax(M, K):
    rng = np.random.default_rng(M + K)
    lut = rng.normal(size=(9, M, K)).astype(np.float32)
    lut[0] = 0.0  # an all-zero row: scale floors at 1e-12 * fp32(1 / 127)
    _assert_quantize_matches_jax(lut, M, K)


@pytest.mark.parametrize("M", [12, 48])
@pytest.mark.parametrize("magnitude", [1e-2, 1.0, 1e2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_lut_int8_matches_jax_at_magnitudes(seed, magnitude, M):
    """Bit-equal to the jitted JAX quantizer at LUT magnitudes 1e-2 to 1e2,
    over enough (query, group) scales that a divided scale, 1 ulp off the
    multiplied one for a few percent of them, would show."""
    rng = np.random.default_rng(seed)
    lut = (rng.normal(size=(64, M, 256)) * magnitude).astype(np.float32)
    lut[0] = 0.0
    _assert_quantize_matches_jax(lut, M, 256)


def _tile_inputs(seed, Q, nlist, Lpad, M, K, nprobe):
    rng = np.random.default_rng(seed)
    cells = _cells(seed, Q, nlist, nprobe)
    _, wc, slot_pair = cuda_ivf.group_pairs(torch.from_numpy(cells), Q, nlist,
                                            nprobe)
    qidx = cuda_ivf.slot_queries(slot_pair, nprobe, Q)
    codes = rng.integers(0, K, size=(nlist, Lpad, M)).astype(np.uint8)
    lut = rng.normal(size=(Q, M, K)).astype(np.float32)
    return wc, qidx, codes, lut


@pytest.mark.parametrize("Q,nlist,Lpad,M,K,nprobe", [
    (20, 8, 128, 4, 32, 4), (12, 6, 640, 8, 32, 3), (9, 4, 128, 12, 256, 2)])
@pytest.mark.parametrize("lut_dtype", ["bf16", "int8"])
def test_score_work_tiles_reference_matches_jax(Q, nlist, Lpad, M, K, nprobe,
                                                lut_dtype):
    """The plain K2 / K3 against JAX's _score_work_tiles (Pallas interpret
    mode) on the same tiles: bf16 to 1e-5 (the MXU adds in another order),
    int8 to 1e-6 (exact int32 parts, the same f32 combine), each side with
    its own int8 LUT (JAX's from its jitted quantizer, as it serves)."""
    wc, qidx, codes, lut = _tile_inputs(Q + Lpad + M, Q, nlist, Lpad, M, K,
                                        nprobe)
    gm = adc.group_size(M, K)
    perm = jax_padc.permute_lut(jnp.asarray(lut), gm)
    if lut_dtype == "int8":
        lut_i8, scales = adc.quantize_lut_int8(torch.from_numpy(lut), gm)
        lut_z = torch.cat([lut_i8, lut_i8.new_zeros((1, M, K))])
        scales_z = torch.cat([scales, scales.new_zeros((1, M // gm))])
        j_q, j_s = jax_quantize_lut_int8(perm, gm, K)
        j_lut = jnp.concatenate([j_q, jnp.zeros((1, M * K), jnp.int8)])
        j_scales = jnp.concatenate([j_s, jnp.zeros((1, M // gm))])
        tol = 1e-6
    else:
        lut_z = torch.cat([torch.from_numpy(lut).to(torch.bfloat16),
                           torch.zeros((1, M, K), dtype=torch.bfloat16)])
        scales_z = j_scales = None
        j_lut = jnp.concatenate([perm.astype(jnp.bfloat16),
                                 jnp.zeros((1, M * K), jnp.bfloat16)])
        tol = 1e-5
    want = np.asarray(jax_pivf._score_work_tiles(
        jnp.asarray(wc.numpy()), jnp.asarray(qidx.numpy()), j_lut,
        jnp.asarray(codes), K, scales_z=j_scales))
    got = cuda_ivf.score_work_tiles_reference(wc, qidx, lut_z,
                                              torch.from_numpy(codes), scales_z)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # the wrapper takes the plain version for CPU tensors, counting nothing
    before = dict(cuda_ivf.score_work_tiles.launches)
    again = cuda_ivf.score_work_tiles(wc, qidx, lut_z.contiguous(),
                                      torch.from_numpy(codes), scales_z)
    assert torch.equal(again, got)
    assert cuda_ivf.score_work_tiles.launches == before


def test_score_codes_int8_reference_matches_pallas_interpret():
    """The plain K4 against adc_scores_pallas_int8, the LUT's lane order
    undone, to 1e-6."""
    M, K, Q, N = 8, 32, 128, 256
    rng = np.random.default_rng(11)
    lut = rng.normal(size=(Q, M, K)).astype(np.float32)
    codes = rng.integers(0, K, size=(N, M)).astype(np.uint8)
    gm = adc.group_size(M, K)
    j_q, j_s = jax_padc.quantize_lut_int8(
        jax_padc.permute_lut(jnp.asarray(lut), gm), gm, K)
    want = np.asarray(jax_padc.adc_scores_pallas_int8(
        j_q, j_s, jnp.asarray(codes.astype(np.int32)), K))
    lut_i8 = torch.from_numpy(np.asarray(j_q).reshape(Q, M // gm, K, gm)
                              .transpose(0, 1, 3, 2).reshape(Q, M, K).copy())
    scales = torch.tensor(np.asarray(j_s))
    got = adc.score_codes_int8_reference(lut_i8, scales,
                                         torch.from_numpy(codes))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(adc_scores_int8(lut_i8, scales, torch.from_numpy(codes)),
                       got)


@pytest.mark.parametrize("value", [127, -127])
def test_score_codes_int8_reference_extremes_match_pallas_interpret(value):
    """All-+127 and all--127 int8 LUTs at gm=8 (K4's lane extremes): the
    plain K4 equals adc_scores_pallas_int8 exactly."""
    M, K, Q, N = 8, 32, 128, 256
    rng = np.random.default_rng(12)
    codes = rng.integers(0, K, size=(N, M)).astype(np.uint8)
    scales = (rng.random((Q, 1)) + 0.5).astype(np.float32)
    lut_i8 = np.full((Q, M, K), value, np.int8)
    want = np.asarray(jax_padc.adc_scores_pallas_int8(
        jnp.asarray(lut_i8.reshape(Q, M * K)), jnp.asarray(scales),
        jnp.asarray(codes.astype(np.int32)), K))
    got = adc.score_codes_int8_reference(torch.from_numpy(lut_i8),
                                         torch.from_numpy(scales),
                                         torch.from_numpy(codes))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted({**bench_k4.VARIANTS,
                                         **bench_k4.DIAGNOSTICS}))
def test_bench_k4_edits_match_the_kernel_source(name):
    """Each variant recipes/bench_k4.py builds edits csrc/adc_scan_i8.cu at
    one place per edit, so the bench times what it says it times."""
    text = (build.CSRC_DIR / "adc_scan_i8.cu").read_text()
    edits = {**bench_k4.VARIANTS, **bench_k4.DIAGNOSTICS}[name]
    assert bench_k4.variant_text(text, edits) != text


# ---- end to end ----------------------------------------------------------

@pytest.mark.parametrize("which", ["built", "spilled"])
def test_serve_search_xla_matches_jax(which, request):
    """mode="xla" on the same JAX-built index: scores to 1e-5, ids equal
    except near-ties."""
    index, _, _, _, queries = request.getfixturevalue(which)
    want_s, want_i = jax_ivf.serve_search(index, queries, topk=10, nprobe=4,
                                          mode="xla")
    got_s, got_i = ivf.serve_search(_port_index(index), queries, topk=10,
                                    nprobe=4, mode="xla", device="cpu")
    _assert_ids_near_ties(got_i, want_i, got_s, want_s, 1e-5)


@pytest.mark.parametrize("which", ["built", "spilled"])
@pytest.mark.parametrize("lut_dtype", ["bf16", "int8"])
def test_serve_search_pallas_matches_jax_interpret(which, lut_dtype, request):
    """mode="pallas": the port's cell-grouped path (plain K2 / K3 on the
    CPU, plain K1 on the spill in both modes) against JAX's interpret-mode
    kernels, with a padded last query batch: scores rank for rank to 1e-5,
    ids equal except near-ties (the spilled corpus quantizes many docs to
    the same codes), top-10 overlap >= 0.99 on the index without a spill,
    and every score within 1e-5 of the port's own plain re-sum of that
    doc."""
    index, _, _, _, queries = request.getfixturevalue(which)
    want_s, want_i = jax_ivf.serve_search(index, queries, topk=10, nprobe=8,
                                          mode="pallas", lut_dtype=lut_dtype,
                                          search_batch=20)
    port = _port_index(index)
    got_s, got_i = ivf.serve_search(port, queries, topk=10, nprobe=8,
                                    mode="pallas", lut_dtype=lut_dtype,
                                    search_batch=20, device="cpu")
    _assert_ids_near_ties(got_i, want_i, got_s, want_s, 1e-5)
    if which == "built":
        assert _overlap(got_i, want_i) >= 0.99
    np.testing.assert_allclose(got_s, _resum(port, queries, got_i, lut_dtype),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lut_dtype,rel", [("bf16", 5e-3), ("int8", 5e-2)])
def test_spill_segment_merged_as_search_xla(spilled, lut_dtype, rel):
    """With a spill segment the cell-grouped path (K1 on the spill)
    agrees with search_xla to the LUT's precision: every score is the
    port's own plain re-sum, and every returned doc's exact fp32 score
    clears search_xla's 10th best less the precision tolerance (ids
    themselves may swap: the clustered corpus quantizes many docs to the
    same codes, as tests/test_ivf.py notes)."""
    index, _, codes, cent, queries = spilled
    port = _port_index(index)
    x_s, x_i = ivf.search_xla(port, queries, topk=10, nprobe=4, device="cpu")
    p_s, p_i = ivf.serve_search(port, queries, topk=10, nprobe=4,
                                mode="pallas", lut_dtype=lut_dtype,
                                device="cpu")
    np.testing.assert_allclose(p_s, _resum(port, queries, p_i, lut_dtype),
                               rtol=1e-5, atol=1e-5)
    assert np.isin(p_i, index.spill_ids).any()  # the spill is really merged
    exact = adc.score_codes_reference(
        adc.build_lut(torch.from_numpy(queries), torch.from_numpy(cent)),
        torch.from_numpy(codes)).numpy()
    true_s = np.take_along_axis(exact, p_i, axis=1)
    floor = x_s[:, -1:] - rel * np.abs(x_s).max(1, keepdims=True)
    assert (true_s >= floor).all()
    np.testing.assert_allclose(p_s, x_s, rtol=0,
                               atol=rel * np.abs(x_s).max())


def test_full_probe_cell_grouped_equals_flat_bf16(built):
    """nprobe = nlist on the CPU path scores every doc with the bf16 LUT, as
    the flat index does: equal scores rank for rank."""
    from repconc_tpu_torch.index.cuda_adc import CudaADCIndex

    index, _, codes, cent, queries = built
    s_ivf, _ = cuda_ivf.CudaIVFIndex(_port_index(index), device="cpu").search(
        queries, topk=20, nprobe=index.nlist)
    s_flat, _ = CudaADCIndex(codes, cent, device="cpu").search(queries, 20)
    np.testing.assert_array_equal(s_ivf, s_flat)


def test_serve_search_unported_options_raise(built):
    """mesh= at world size 1 (a gloo group) serves the cell-sharded index:
    the one-process cell-grouped result, bit for bit; mode="xla" under a
    mesh raises (no cell-sharded scan, and never the unsharded index).
    Decoded serving: serve_search and CudaIVFIndex take it (on the CPU with
    the pallas mode), and an unknown serving raises."""
    from test_torch_distributed import world1_mesh

    port = _port_index(built[0])
    q = built[4][:2]
    want = ivf.serve_search(port, q, topk=5, nprobe=4, mode="pallas",
                            device="cpu")
    with world1_mesh() as mesh:
        got = ivf.serve_search(port, q, topk=5, nprobe=4, mesh=mesh,
                               device="cpu")
        with pytest.raises(ValueError, match="xla"):
            ivf.serve_search(port, q, mode="xla", mesh=mesh, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    s, i = ivf.serve_search(port, q, topk=5, nprobe=4, mode="pallas",
                            serving="decoded", device="cpu")
    assert s.shape == (2, 5) and (i >= 0).all()
    index = cuda_ivf.CudaIVFIndex(port, serving="decoded_int8", device="cpu")
    assert index.store[0] == "int8"
    with pytest.raises(ValueError):
        ivf.serve_search(port, q, serving="dense", device="cpu")
    s, i = ivf.serve_search(port, q[:0], topk=5, mode="pallas", device="cpu")
    assert s.shape == (0, 5) and i.shape == (0, 5)
