"""The rest of the port's IVF against the JAX package on the CPU: the
balanced coarse quantizer (Sinkhorn-constrained k-means, build_ivf(
balanced=True)), decoded residency (decode_cells, decode_cells_int8, the
decoded scorers and CudaIVFIndex(serving="decoded*")) and the
run_ivf_sweep CLI.

The decoded scorers are XLA in the JAX package and torch ops in the port,
so both run here as they run on a card (JAX's spill scan, a Pallas
kernel, in interpret mode). The port's k-means++ seeds come from a torch
generator; where a test needs JAX's centroids, it hands the port JAX's
k-means++ seeds on the same points."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repconc_tpu.cli import run_ivf_sweep as jax_sweep
from repconc_tpu.core.config import EncoderConfig, RepConcConfig
from repconc_tpu.index import ivf as jax_ivf
from repconc_tpu.index import kmeans as jax_kmeans
from repconc_tpu.index import pallas_ivf as jax_pivf
from repconc_tpu.index.kmeans import pq_fit
from repconc_tpu.models.repconc_model import save_pretrained
from repconc_tpu.quant import encode as jax_encode
from repconc_tpu_torch.cli import run_ivf_sweep
from repconc_tpu_torch.index import cuda_ivf, ivf, kmeans
from repconc_tpu_torch.quant.sinkhorn import sinkhorn_assign
from test_torch_ivf import (_assert_ids_near_ties, _port_index,  # noqa: F401
                            built, spilled)


@pytest.fixture()
def jax_seeds(monkeypatch):
    """The port's k-means++ replaced by JAX's at key 2022 (the seed every
    build here uses), on the same points."""
    def seeds(x, K, generator):
        init = jax_kmeans.kmeans_plusplus_init(
            jnp.asarray(x.cpu().numpy()), K, jax.random.key(2022))
        return torch.from_numpy(np.asarray(init)).to(x.device)

    monkeypatch.setattr(kmeans, "kmeans_plusplus_init", seeds)


# ---- balanced k-means and the balanced build ---------------------------

def _points(seed, n=600, d=16, clusters=6):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(clusters, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, clusters, n)]
            + rng.normal(size=(n, d)).astype(np.float32))


@pytest.mark.parametrize("K", [8, 16])
def test_balanced_kmeans_matches_jax(K):
    """balanced_kmeans_fit from JAX's k-means++ seeds: the centroids and
    mse of JAX's balanced_kmeans_fit at the same key within rtol 1e-5, and
    the Sinkhorn assignments of the points equal (no fp32 near-tie here)."""
    x = _points(K)
    key = jax.random.key(2022)
    want_c, want_mse = jax_kmeans.balanced_kmeans_fit(jnp.asarray(x), K,
                                                      iters=8, key=key)
    init = jax_kmeans.kmeans_plusplus_init(jnp.asarray(x), K, key)
    got_c, got_mse = kmeans.balanced_kmeans_fit(
        torch.from_numpy(x), K, iters=8,
        init=torch.from_numpy(np.array(init)))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(got_mse), float(want_mse), rtol=1e-5)

    def sk_codes(c):
        xt, ct = torch.from_numpy(x), torch.as_tensor(np.asarray(c))
        dist = ((xt * xt).sum(-1, keepdim=True) - 2 * xt @ ct.T
                + (ct * ct).sum(-1)[None])
        return sinkhorn_assign(dist[None], 0.05, 30)[:, 0].numpy()

    from repconc_tpu.quant.sinkhorn import sinkhorn_assign as jax_sk

    xj, cj = jnp.asarray(x), want_c
    dist = (jnp.sum(xj * xj, -1, keepdims=True)
            - 2 * jnp.dot(xj, cj.T, precision=jax.lax.Precision.HIGHEST)
            + jnp.sum(cj * cj, -1)[None])
    want_codes = np.asarray(jax_sk(dist[None], 0.05, 30))[:, 0]
    got_codes = sk_codes(got_c.numpy())
    np.testing.assert_array_equal(got_codes, want_codes)


@pytest.mark.parametrize("pad_quantile", [0.995, 0.5])
def test_build_ivf_balanced_matches_jax(pad_quantile, jax_seeds):
    """build_ivf(balanced=True) from JAX's k-means++ seeds: the coarse
    centroids of JAX's balanced build within 1e-5, and the lists, Lpad,
    sizes and spill segment equal (a low pad quantile forces a spill)."""
    rng = np.random.default_rng(9)
    embeds = _points(1, n=1500, d=32, clusters=12)
    cent, _ = pq_fit(jnp.asarray(embeds[:800]), M=4, K=16, iters=4)
    cent = np.asarray(cent)
    codes = rng.integers(0, 16, size=(1500, 4)).astype(np.uint8)
    kw = dict(nlist=16, kmeans_iters=5, pad_quantile=pad_quantile,
              balanced=True)
    want = jax_ivf.build_ivf(embeds, codes, cent, **kw)
    got = ivf.build_ivf(embeds, codes, cent, device="cpu", **kw)
    np.testing.assert_allclose(got.coarse_centroids, want.coarse_centroids,
                               rtol=1e-5, atol=1e-5)
    assert got.Lpad == want.Lpad
    for name in ("cell_codes", "cell_ids", "cell_sizes", "spill_codes",
                 "spill_ids"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    if pad_quantile < 0.9:
        assert len(got.spill_ids) > 0


def test_build_ivf_balanced_is_tighter(built):
    """The port's own balanced build (its own k-means++ draws) over the
    codes: every doc once, and lists no longer than the plain build's."""
    _, _, codes, cent, _ = built
    plain = ivf.build_ivf_from_codes(codes, cent, nlist=16, kmeans_iters=6,
                                     device="cpu")
    bal = ivf.build_ivf_from_codes(codes, cent, nlist=16, kmeans_iters=6,
                                   balanced=True, device="cpu")
    ids = np.concatenate([bal.cell_ids[bal.cell_ids >= 0], bal.spill_ids])
    assert sorted(ids.tolist()) == list(range(len(codes)))
    sizes = np.bincount(ivf.assign_cells(
        ivf.ReconstructionView(codes, cent, "cpu"),
        torch.as_tensor(bal.coarse_centroids)).numpy(), minlength=16)
    plain_sizes = np.bincount(ivf.assign_cells(
        ivf.ReconstructionView(codes, cent, "cpu"),
        torch.as_tensor(plain.coarse_centroids)).numpy(), minlength=16)
    assert sizes.max() <= plain_sizes.max()
    assert bal.Lpad <= plain.Lpad


# ---- decoded residency --------------------------------------------------

@pytest.mark.parametrize("which", ["built", "spilled"])
def test_decoded_stores_bit_equal_to_jax(which, request):
    """decode_cells (bf16) and decode_cells_int8 (int8 vectors and the
    per-dimension doc scale) equal JAX's bit for bit: a gather, one
    rounding, a half-to-even round."""
    index = request.getfixturevalue(which)[0]
    codes_t = torch.as_tensor(index.cell_codes)
    cent_t = torch.as_tensor(index.centroids)
    want = np.asarray(jax_pivf.decode_cells(jnp.asarray(index.cell_codes),
                                            jnp.asarray(index.centroids),
                                            chunk=4))
    got = cuda_ivf.decode_cells(codes_t, cent_t, chunk=3)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))
    want_v, want_s = jax_pivf.decode_cells_int8(
        jnp.asarray(index.cell_codes), jnp.asarray(index.centroids), chunk=4)
    got_v, got_s = cuda_ivf.decode_cells_int8(codes_t, cent_t, chunk=5)
    assert got_v.dtype == torch.int8
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("serving", ["decoded", "decoded_int8"])
@pytest.mark.parametrize("which", ["built", "spilled"])
def test_decoded_search_matches_jax(which, serving, request):
    """CudaIVFIndex(serving=...) on the CPU against JAX's
    PallasIVFIndex(index, serving=...) (XLA scorers, the spill through
    JAX's ADC kernel in interpret mode): int8 scores bit-equal (exact
    integer sums, the same scale arithmetic), bf16 within 1e-5 relative
    (fp32 sums in another order); ids equal except near-ties."""
    index, _, _, _, queries = request.getfixturevalue(which)
    kw = dict(topk=20, nprobe=6)
    want_s, want_i = jax_pivf.PallasIVFIndex(index, serving=serving).search(
        queries, **kw)
    port = cuda_ivf.CudaIVFIndex(_port_index(index), serving=serving,
                                 device="cpu")
    got_s, got_i = port.search(queries, **kw)
    if which == "spilled":
        assert np.isin(got_i, index.spill_ids).any()
    if serving == "decoded_int8":
        np.testing.assert_array_equal(got_s, np.asarray(want_s))
        _assert_ids_near_ties(got_i, np.asarray(want_i), got_s,
                              np.asarray(want_s), 0.0)
    else:
        tol = 1e-5 * float(np.abs(want_s).max())
        _assert_ids_near_ties(got_i, np.asarray(want_i), got_s,
                              np.asarray(want_s), tol)


def test_decoded_modes_and_store(built):
    """enable_decoded_serving sets the default; a per-call serving=
    builds the store and leaves the default; one dtype is resident at a
    time; decoded_bytes counts the store; set_centroids drops a stale store
    and rebuilds it when decoded is the default; an unknown serving raises;
    serve_search takes the decoded path, and with mesh= at world size 1
    (a gloo group) the cell-sharded decoded path, bit for bit."""
    index, _, _, cent, queries = built
    port = cuda_ivf.CudaIVFIndex(_port_index(index), device="cpu")
    assert port.serving == "adc" and port.store is None
    s_dec, _ = port.search(queries, topk=10, nprobe=4, serving="decoded")
    assert port.serving == "adc" and port.store[0] == "bf16"
    nlist, Lpad, _ = index.cell_codes.shape
    assert port.decoded_bytes() == nlist * Lpad * 32 * 2
    assert port.decoded_bytes("int8") == nlist * Lpad * 32
    assert port.store[1].numel() * 2 == port.decoded_bytes()
    port.enable_decoded_serving("int8")
    assert port.serving == "decoded_int8" and port.store[0] == "int8"
    port.set_centroids(cent * 2)
    assert port.store[0] == "int8"
    np.testing.assert_array_equal(
        port.store[1].numpy(), cuda_ivf.decode_cells_int8(
            port.cell_codes, torch.as_tensor(cent * 2))[0].numpy())
    adc = cuda_ivf.CudaIVFIndex(_port_index(index), device="cpu")
    adc.set_centroids(cent * 2)
    assert adc.store is None
    with pytest.raises(ValueError):
        cuda_ivf.CudaIVFIndex(_port_index(index), serving="dense",
                              device="cpu")
    s, _ = ivf.serve_search(_port_index(index), queries, topk=10, nprobe=4,
                            mode="pallas", serving="decoded", device="cpu")
    np.testing.assert_array_equal(s, s_dec)
    from test_torch_distributed import world1_mesh

    with world1_mesh() as mesh:
        s_mesh, _ = ivf.serve_search(_port_index(index), queries, topk=10,
                                     nprobe=4, mode="pallas", mesh=mesh,
                                     serving="decoded", device="cpu")
    np.testing.assert_array_equal(s_mesh, s_dec)


def test_decoded_int8_sums_are_exact_integers():
    """The int8 scorer multiplies int8 values as fp32: below 2^24 every
    partial sum is an exact integer, so the result equals the int32 sum;
    a width where it would not be exact raises."""
    rng = np.random.default_rng(0)
    D, Lpad = 1040, 8
    vecs = torch.from_numpy(rng.choice([-127, 127], size=(2, Lpad, D))
                            .astype(np.int8))
    q8 = torch.from_numpy(rng.choice([-127, 127], size=(3, D)).astype(np.int8))
    work_cell = torch.tensor([0, 1], dtype=torch.int32)
    qidx = torch.full((2, cuda_ivf.QT_G), 2, dtype=torch.int32)
    qidx[:, 0] = 0
    qidx[:, 1] = 1
    q8[2] = 0
    scale = torch.ones(3)
    got = cuda_ivf.score_tiles_decoded_int8(work_cell, qidx, q8, scale, vecs)
    want = torch.einsum("sd,tld->tsl", q8.long(), vecs.long()[work_cell.long()])
    for t in range(2):
        assert torch.equal(got[t, :2].long(), want[t, :2])
    assert float(got[:, 2:].abs().max()) == 0.0
    with pytest.raises(ValueError):
        cuda_ivf.score_tiles_decoded_int8(
            work_cell, qidx, torch.zeros((3, 1041), dtype=torch.int8), scale,
            torch.zeros((2, Lpad, 1041), dtype=torch.int8))


# ---- run_ivf_sweep ------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_inputs(tmp_path_factory):
    """tests/test_ivf_sweep.py's toy inputs: 1500 codes of 64-dim points
    (M=4, K=32), 16 queries, a model dir holding the codebook."""
    tmp = tmp_path_factory.mktemp("sweep")
    rng = np.random.default_rng(3)
    D, M, K, N, Q = 64, 4, 32, 1500, 16
    emb = rng.normal(size=(N, D)).astype(np.float32)
    cent = np.asarray(pq_fit(jnp.asarray(emb[:800]), M=M, K=K, iters=4)[0])
    codes = np.asarray(jax_encode(jnp.asarray(emb), jnp.asarray(cent),
                                  use_constraint=False)).astype(np.uint8)
    np.save(tmp / "codes.npy", codes)
    np.save(tmp / "q.npy", rng.normal(size=(Q, D)).astype(np.float32))
    cfg = RepConcConfig(encoder=EncoderConfig(hidden_size=D), MCQ_M=M, MCQ_K=K)
    save_pretrained(str(tmp / "model"), cfg,
                    {"centroids": cent, "rotation": np.eye(D, dtype=np.float32)})
    return tmp


SWEEPS = {
    "xla": [],
    "pallas_int8": ["--use_pallas", "--lut_dtype", "int8"],
    "decoded_int8": ["--use_pallas", "--serving", "decoded_int8"],
    "balanced": ["--balanced"],
}


@pytest.mark.parametrize("case", sorted(SWEEPS))
def test_sweep_matches_jax_cli(case, sweep_inputs, tmp_path, jax_seeds):
    """The port's run_ivf_sweep against the JAX CLI on the same inputs,
    with JAX's k-means++ seeds: the same sweep.json keys, the same nprobe
    and recall columns (qps is a time and differs), and recall 1.0 at full
    probe but for int8 rounding.

    One exception, the int8 LUT of ADC serving. Its quantizer is JAX's
    jitted one bit for bit (tests/test_torch_ivf.py), but its input, the
    fp32 LUT of build_lut, is not: torch's einsum and XLA's dot on the CPU
    sum each entry's dsub products in another order, so entries differ by
    an ulp. A group's amax, and with it its scale and int8 values, then
    differs now and then, and a near-tie doc can cross the top-10, so that
    column is held to within two of its Q * topk = 160 ids."""
    d = sweep_inputs
    argv = ["--codes_path", str(d / "codes.npy"),
            "--query_embed_path", str(d / "q.npy"),
            "--model_name_or_path", str(d / "model"),
            "--nlist", "8", "--nprobes", "2,4,8", "--topk", "10"]
    argv += SWEEPS[case]
    jax_sweep.main(argv + ["--out", str(tmp_path / "jax.json")])
    run_ivf_sweep.main(argv + ["--out", str(tmp_path / "port.json"),
                               "--device", "cpu"])
    want = json.load(open(tmp_path / "jax.json"))
    got = json.load(open(tmp_path / "port.json"))
    assert got.keys() == want.keys()
    assert {k: v for k, v in got.items() if k != "results"} == {
        k: v for k, v in want.items() if k != "results"}
    assert [r.keys() for r in got["results"]] == [r.keys()
                                                  for r in want["results"]]
    rkey = "recall_vs_exact@10"
    assert [r["nprobe"] for r in got["results"]] == [2, 4, 8]
    assert [r["nprobe"] for r in want["results"]] == [2, 4, 8]
    slack = 2 / 160 if case == "pallas_int8" else 0.0
    for g, w in zip(got["results"], want["results"]):
        assert abs(g[rkey] - w[rkey]) <= slack + 1e-9, (g, w)
    recalls = [r[rkey] for r in got["results"]]
    assert recalls == sorted(recalls)
    assert recalls[-1] >= (0.9 if "int8" in case else 1.0)
