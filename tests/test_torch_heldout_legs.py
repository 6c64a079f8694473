"""The held-out check's dense and OPQ legs (repconc_tpu_torch/recipes/
heldout_matrix.sh, LEGS="dense opq"), against the TPU's runs
(docs/heldout_r5/) and the JAX package.

- test_opq_eval_codes_equal_the_warmup_index: on toy data, the recipe's
  opq-eval encodes the corpus through the warm-up model to the codes that
  stage 5 wrote into warmup_index, but for fp32 near-ties. So the OPQ
  leg may score its dev queries against warmup_index's codes instead of
  encoding the corpus a second time.
- test_opq_fixture_*: the committed inputs of the OPQ leg's search
  (repconc_tpu_torch/fixtures/heldout_m12_opq/): the port's CPU search
  reproduces the committed metric.json, within the leg's bars of the TPU
  run's MRR@10 and NDCG@10, and its top-1000 is the JAX package's except
  at fp32 near-ties. They need nothing outside the checkout.
- test_dense_leg_committed_metrics_within_its_bars: the dense leg's CPU
  run's metric.json (repconc_tpu_torch/fixtures/heldout_dense/) lies
  within its bars of docs/heldout_r5/dense_dev.json.
- test_dense_leg_*: the dense leg's 614 MB of corpus embeddings are not
  committed. With REPCONC_HELDOUT_DIR set to the workspace of a
  heldout_matrix.sh run, the port's CPU flat search over its dense/
  embeddings reproduces the run's metric.json, within the dense bars of
  docs/heldout_r5/dense_dev.json, and its top-200 is the JAX package's
  but for near-ties on 16 queries. They skip without it.
"""
import json
import os

import numpy as np
import pytest

from repconc_tpu.index import adc as jax_adc
from repconc_tpu.index import flat as jax_flat
from repconc_tpu_torch.fixtures import heldout

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_DIR = os.path.join(ROOT, "docs", "heldout_r5")
TIE_BAR = 1e-5  # of the operands' squared norms (PERF.md, near-ties)
DENSE_LEG = heldout.LEGS["heldout_dense"]  # bars set before the port's run


def _tpu(name):
    with open(os.path.join(TPU_DIR, name)) as f:
        return json.load(f)


# -- opq-eval's codes are stage 5's ---------------------------------------------

def test_opq_eval_codes_equal_the_warmup_index(tmp_path):
    """Toy data (2,000 docs, a 2-layer 64-wide BERT), the held-out leg's
    settings (mean pooling, METRIC_IP, M=8 here), the recipe's stages 2, 3
    and 5 and its opq-eval through the CLIs: opq-eval's corpus codes and
    ids equal warmup_index's, except where the two centroids are fp32
    near-ties for the rotated dense embedding."""
    from repconc_tpu_torch.cli import (run_customize_dense, run_dense_eval,
                                       run_repconc_eval, run_warmup)
    from repconc_tpu_torch.recipes import make_pipeline_data

    ws = tmp_path / "ws"
    make_pipeline_data.make_toy(str(ws))
    data, out = ws / "data", ws / "experiments" / "toy"
    dense, exp = out / "dense_model", out / "m8"
    run_customize_dense.main([
        "--model_name_or_path", str(ws / "models" / "toy-bert"),
        "--similarity_metric", "METRIC_IP", "--pooling", "mean",
        "--output_dir", str(dense)])
    run_dense_eval.main([
        "--model_name_or_path", str(dense),
        "--corpus_path", str(data / "corpus.tsv"),
        "--query_path", str(data / "queries.dev.small.tsv"),
        "--qrel_path", str(data / "qrels.dev.small.tsv"),
        "--out_corpus_dir", str(out / "dense"),
        "--out_query_dir", str(out / "dense" / "dev"),
        "--max_seq_length", "32", "--topk", "200",
        "--save_corpus_embed", "--save_query_embed", "--device", "cpu"])
    run_warmup.main([
        "--model_name_or_path", str(dense), "--MCQ_M", "8",
        "--input_corpus_embed_path", str(out / "dense" / "corpus_embeds.npy"),
        "--input_corpus_ids_path", str(out / "dense" / "corpus_ids.npy"),
        "--output_model_dir", str(exp / "warmup_model"),
        "--output_index_dir", str(exp / "warmup_index"),
        # a short fit: the check holds for any rotation and centroids
        "--opq_outer_iters", "2", "--opq_pq_iters", "2",
        "--final_pq_iters", "4", "--device", "cpu"])
    run_repconc_eval.main([
        "--model_name_or_path", str(exp / "warmup_model"),
        "--corpus_path", str(data / "corpus.tsv"),
        "--query_path", str(data / "queries.dev.small.tsv"),
        "--qrel_path", str(data / "qrels.dev.small.tsv"),
        "--out_corpus_dir", str(exp / "opq_index"),
        "--out_query_dir", str(exp / "opq_index" / "dev"),
        "--max_seq_length", "32", "--topk", "1000", "--device", "cpu"])
    got = np.load(exp / "opq_index" / "codes.npy")
    want = np.load(exp / "warmup_index" / "codes.npy")
    np.testing.assert_array_equal(np.load(exp / "opq_index" / "corpus_ids.npy"),
                                  np.load(exp / "warmup_index" / "corpus_ids.npy"))
    assert got.shape == want.shape == (2000, 8) and got.dtype == np.uint8
    if (got != want).any():
        from repconc_tpu_torch.core.checkpoint import load_params

        params = load_params(str(exp / "warmup_model"))
        rotation = np.asarray(params["rotation"], np.float64)
        x = np.load(out / "dense" / "corpus_embeds.npy") @ rotation.T
        centroids = np.asarray(params["centroids"], np.float64)
        M = centroids.shape[0]
        x = x.reshape(len(x), M, -1)
        for r, m in zip(*np.nonzero(got != want)):
            ca, cb = centroids[m, want[r, m]], centroids[m, got[r, m]]
            scale = (x[r, m] ** 2).sum() + max((ca ** 2).sum(),
                                               (cb ** 2).sum())
            gap = abs(((x[r, m] - ca) ** 2).sum() - ((x[r, m] - cb) ** 2).sum())
            assert gap / scale <= TIE_BAR, (r, m, gap / scale)
    metric = json.loads((exp / "opq_index" / "dev" / "metric.json").read_text())
    assert np.isfinite(metric["mrr"]["MRR@10"])


# -- the OPQ leg's fixture --------------------------------------------------------

@pytest.fixture(scope="module")
def opq_run(tmp_path_factory):
    fx = heldout.load(heldout.OPQ_FIXTURE_DIR)
    scores, docids = heldout.search(fx, device="cpu")
    run_path = str(tmp_path_factory.mktemp("heldout_opq") / "run.tsv")
    return fx, scores, docids, heldout.score_run(fx, scores, docids, run_path)


def test_opq_fixture_reproduces_the_committed_metrics(opq_run):
    """The port's CPU search over the OPQ fixture: the committed
    metric.json exactly; beside the TPU's run of the leg
    (m12_opq_index_dev.json) the same 241 queries, MRR@10 and NDCG@10
    within the bars set before the port's run."""
    fx, scores, docids, metric = opq_run
    assert fx["codes"].shape == (200_000, 12) and fx["codes"].dtype == np.uint8
    assert fx["query_embeds"].shape == (241, 768)
    assert fx["centroids"].shape == (12, 256, 64)
    assert scores.shape == docids.shape == (241, heldout.TOPK)
    assert metric == fx["metric"]
    leg = heldout.LEGS["heldout_m12_opq"]
    tpu = _tpu(leg["reference"])
    assert tpu["mrr"]["MRR@10"] == leg["tpu_mrr10"]
    out = heldout.compare(metric, tpu)
    assert out["queries"] == 241
    assert abs(out["delta_mrr_at_10"]) <= leg["mrr10_bar"], out["delta_mrr_at_10"]
    assert abs(out["delta_ndcg_at_10"]) <= leg["ndcg10_bar"], out["delta_ndcg_at_10"]
    assert heldout.bars_met(out, "heldout_m12_opq")


def test_opq_fixture_topk_matches_jax(opq_run):
    """The JAX package's CPU batch_adc_search on the OPQ fixture: ids equal
    except where the swapped docs' float64 scores (fp32 LUT) lie within
    1e-5 of the query's score scale, scores within that scale too."""
    fx, scores, docids, _ = opq_run
    want_s, want_d = jax_adc.batch_adc_search(
        fx["qids"], fx["query_embeds"], fx["corpus_ids"], fx["codes"],
        fx["centroids"], topk=heldout.TOPK, batch_size=heldout.SEARCH_BATCH)
    Q, M = fx["query_embeds"].shape[0], fx["centroids"].shape[0]
    lut = np.einsum("qmd,mkd->qmk",
                    fx["query_embeds"].reshape(Q, M, -1).astype(np.float64),
                    fx["centroids"].astype(np.float64))
    tol = 1e-5 * np.abs(lut).max(-1).sum(-1)  # per query
    assert (np.abs(scores - want_s) <= tol[:, None]).all()
    row = {d: j for j, d in enumerate(fx["corpus_ids"])}
    rows = np.vectorize(row.get)
    got_i, want_i = rows(docids), rows(want_d)
    codes = fx["codes"].astype(np.int64)
    for q in np.nonzero((got_i != want_i).any(1))[0]:
        diff = got_i[q] != want_i[q]
        exact = [lut[q, np.arange(M), codes[i]].sum(-1)
                 for i in (got_i[q][diff], want_i[q][diff])]
        assert (np.abs(exact[0] - exact[1]) <= tol[q]).all(), q


def test_both_fixtures_hold_the_same_split():
    """The OPQ and RepCONC fixtures judge the same 241 dev queries with the
    same qrels over the same 200,000 docs, in the order of each model's
    encode."""
    opq, conc = heldout.load(heldout.OPQ_FIXTURE_DIR), heldout.load()
    np.testing.assert_array_equal(opq["qids"], conc["qids"])
    with open(opq["qrel_path"]) as f, open(conc["qrel_path"]) as g:
        assert f.read() == g.read()
    assert sorted(opq["corpus_ids"]) == sorted(conc["corpus_ids"])
    assert set(opq["metric"]["perquery"]) == set(_tpu(
        "m12_opq_index_dev.json")["perquery"])


# -- the dense leg ----------------------------------------------------------------

def test_dense_leg_committed_metrics_within_its_bars():
    """The committed metric.json of the dense leg's CPU run: against
    dense_dev.json the same 241 queries, |dMRR@10| and |dNDCG@10| within
    0.02."""
    with open(os.path.join(heldout.DENSE_FIXTURE_DIR, heldout.METRIC)) as f:
        metric = json.load(f)
    tpu = _tpu(DENSE_LEG["reference"])
    assert tpu["mrr"]["MRR@10"] == DENSE_LEG["tpu_mrr10"]
    assert DENSE_LEG["mrr10_bar"] == DENSE_LEG["ndcg10_bar"] == 0.02
    out = heldout.compare(metric, tpu)
    assert out["queries"] == 241
    assert (out["mrr_at_10"], out["ndcg_at_10"]) == (0.51183, 0.50402)
    assert abs(out["delta_mrr_at_10"]) <= DENSE_LEG["mrr10_bar"]
    assert abs(out["delta_ndcg_at_10"]) <= DENSE_LEG["ndcg10_bar"]
    assert heldout.bars_met(out, "heldout_dense")


def _dense_dir():
    root = os.environ.get("REPCONC_HELDOUT_DIR")
    if not root:
        pytest.skip("REPCONC_HELDOUT_DIR (a heldout_matrix.sh workspace) is "
                    "not set")
    d = os.path.join(root, "experiments", "synth", "dense")
    if not os.path.exists(os.path.join(d, "corpus_embeds.npy")):
        pytest.skip(f"{d} holds no dense leg (corpus_embeds.npy)")
    return d


@pytest.fixture(scope="module")
def dense_run(tmp_path_factory):
    from repconc_tpu_torch.eval.run_io import write_run_tsv
    from repconc_tpu_torch.eval.trec import evaluate_run
    from repconc_tpu_torch.index.flat import batch_flat_search

    d = _dense_dir()
    corpus = np.load(os.path.join(d, "corpus_embeds.npy"))
    ids = np.load(os.path.join(d, "corpus_ids.npy"))
    queries = np.load(os.path.join(d, "dev", "query_embeds.npy"))
    qids = np.load(os.path.join(d, "dev", "qids.npy"))
    scores, docids = batch_flat_search(qids, queries, ids, corpus, topk=200,
                                       device="cpu")
    run_path = str(tmp_path_factory.mktemp("dense") / "run.tsv")
    write_run_tsv(run_path, qids, scores, docids)
    root = os.environ["REPCONC_HELDOUT_DIR"]
    metric = evaluate_run(os.path.join(root, "data_task",
                                       "qrels.dev.small.tsv"), run_path)
    with open(os.path.join(d, "dev", "metric.json")) as f:
        recorded = json.load(f)
    return dict(corpus=corpus, ids=ids, queries=queries, qids=qids,
                scores=scores, docids=docids, metric=metric,
                recorded=recorded)


def test_dense_leg_within_its_bars(dense_run):
    """The dense leg: the port's CPU search over the workspace's embeddings
    reproduces its metric.json; against dense_dev.json the same 241
    queries, |dMRR@10| and |dNDCG@10| within 0.02."""
    assert dense_run["corpus"].shape == (200_000, 768)
    metric = dense_run["metric"]
    assert metric == dense_run["recorded"]
    out = heldout.compare(metric, _tpu("dense_dev.json"))
    print(f"\ndense leg: MRR@10 {out['mrr_at_10']} (TPU "
          f"{out['reference_mrr_at_10']}), NDCG@10 {out['ndcg_at_10']} (TPU "
          f"{out['reference_ndcg_at_10']}), {out['queries_differ']} queries "
          f"differ")
    assert out["queries"] == 241
    assert abs(out["delta_mrr_at_10"]) <= DENSE_LEG["mrr10_bar"]
    assert abs(out["delta_ndcg_at_10"]) <= DENSE_LEG["ndcg10_bar"]


def test_dense_leg_topk_matches_jax(dense_run):
    """The JAX package's CPU batch_flat_search on 16 of the queries: ids
    equal except where the swapped docs' float64 scores lie within 1e-5 of
    the query's score scale."""
    r = dense_run
    sel = np.arange(0, len(r["qids"]), max(1, len(r["qids"]) // 16))[:16]
    want_s, want_d = jax_flat.batch_flat_search(
        r["qids"][sel], r["queries"][sel], r["ids"], r["corpus"], topk=200)
    q64 = r["queries"][sel].astype(np.float64)
    tol = 1e-5 * np.abs(q64).sum(1) * np.abs(r["corpus"]).max()
    assert (np.abs(r["scores"][sel] - want_s) <= tol[:, None]).all()
    row = {d: j for j, d in enumerate(r["ids"])}
    rows = np.vectorize(row.get)
    got_i, want_i = rows(r["docids"][sel]), rows(want_d)
    for j in np.nonzero((got_i != want_i).any(1))[0]:
        diff = got_i[j] != want_i[j]
        exact = [r["corpus"][i].astype(np.float64) @ q64[j]
                 for i in (got_i[j][diff], want_i[j][diff])]
        assert (np.abs(exact[0] - exact[1]) <= tol[j]).all(), j
