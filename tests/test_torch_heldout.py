"""The held-out check of the main path on the real M=12 model, against the
JAX package on the CPU.

- test_real_model_matches_jax: the M=12 RepCONC checkpoint's best/ dir,
  read from artifacts/r5h_m12_conc_best.tar in place (its members copied
  to a temporary directory, nothing extracted into the repo), encodes 48
  texts of its own vocabulary at max lengths 64 and 128: the port's codes
  equal the JAX package's except at fp32 near-ties, and its query
  embeddings are within 1e-5. Skips without the tar.
- test_fixture_reproduces_the_committed_metrics and
  test_fixture_topk_matches_jax: the committed inputs of the held-out
  search (repconc_tpu_torch/fixtures/heldout_m12/): the port's CPU
  batch_adc_search reproduces the committed metric.json exactly, with
  MRR@10 within 0.02 of the TPU run's, and its top-1000 is the JAX
  package's except at fp32 near-ties. They need no tar and always run.
- test_regenerated_corpus_codes_match_jax: a sample of 4,096 docs of the
  regenerated 200,000-doc corpus, the port's codes from its eval run
  against the JAX package's encode_texts. Skips without the tar and without
  REPCONC_HELDOUT_DIR, a directory holding data_task/corpus.tsv and the
  port's conc_index/{codes,corpus_ids}.npy (README.md, "held-out check").
"""
import json
import os
import tarfile

import numpy as np
import pytest

from repconc_tpu.eval import encode as jax_encode
from repconc_tpu.index import adc as jax_adc
from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu_torch.eval import encode
from repconc_tpu_torch.fixtures import heldout
from repconc_tpu_torch.models.repconc_model import from_pretrained

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONC_TAR = os.path.join(ROOT, "artifacts", "r5h_m12_conc_best.tar")
TIE_BAR = 1e-5  # of the operands' squared norms (PERF.md, near-ties)


@pytest.fixture(scope="module")
def real_model(tmp_path_factory):
    if not os.path.exists(CONC_TAR):
        pytest.skip("artifacts/r5h_m12_conc_best.tar is not in this checkout")
    from transformers import AutoTokenizer

    d = tmp_path_factory.mktemp("m12_conc_best")
    with tarfile.open(CONC_TAR) as tar:
        for member in tar.getmembers():
            if member.isfile() and member.name.startswith("best/"):
                (d / os.path.basename(member.name)).write_bytes(
                    tar.extractfile(member).read())
    config, params = jax_model.from_pretrained(str(d))
    return dict(dir=str(d), config=config, params=params,
                model=from_pretrained(str(d), device="cpu"),
                tok=AutoTokenizer.from_pretrained(str(d)))


def near_tie_gaps(embeds, centroids, codes_a, codes_b):
    """For each (row, m) where the codes differ: how much farther centroid
    b lies from the row's subvector than centroid a, in float64, over the
    operands' squared norms (the scale of the fp32 rounding of
    ||x||^2 - 2 x.c + ||c||^2)."""
    M = centroids.shape[0]
    x = np.asarray(embeds, np.float64).reshape(len(embeds), M, -1)
    c = np.asarray(centroids, np.float64)
    gaps = []
    for r, m in zip(*np.nonzero(codes_a != codes_b)):
        ca, cb = c[m, codes_a[r, m]], c[m, codes_b[r, m]]
        scale = (x[r, m] ** 2).sum() + max((ca ** 2).sum(), (cb ** 2).sum())
        gaps.append(abs(((x[r, m] - ca) ** 2).sum() - ((x[r, m] - cb) ** 2).sum())
                    / scale)
    return np.array(gaps)


def _vocab_texts(tok, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    words = [w for w in tok.get_vocab() if not w.startswith(("[", "##"))]
    return [" ".join(rng.choice(words, size=int(rng.integers(lo, hi))))
            for _ in range(n)]


@pytest.mark.parametrize("max_len", [64, 128])
def test_real_model_matches_jax(real_model, max_len):
    """48 texts of 20-160 vocab words (some cut at max_len): the port's
    codes equal the JAX package's except where the two centroids are
    fp32 near-ties for the JAX embedding; 48 queries' embeddings within
    1e-5."""
    m, tok = real_model["model"], real_model["tok"]
    config, params = real_model["config"], real_model["params"]
    texts = _vocab_texts(tok, 48, 20, 160, seed=max_len)
    kw = dict(batch_size=16, input_text_type="doc")
    got = encode.encode_texts(texts, m, tok, max_len, output="code",
                              device="cpu", **kw)
    want = jax_encode.encode_texts(texts, config, params, tok, max_len,
                                   output="code", **kw)
    assert got.shape == want.shape == (48, 12) and got.dtype == np.uint8
    if (got != want).any():
        x = jax_encode.encode_texts(texts, config, params, tok, max_len, **kw)
        gaps = near_tie_gaps(x, params["centroids"], want, got)
        assert gaps.max() <= TIE_BAR, gaps
    queries = _vocab_texts(tok, 48, 2, 12, seed=max_len + 1)
    kw = dict(batch_size=16, input_text_type="query")
    q_got = encode.encode_texts(queries, m, tok, max_len, device="cpu", **kw)
    q_want = jax_encode.encode_texts(queries, config, params, tok, max_len,
                                     **kw)
    np.testing.assert_allclose(q_got, q_want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def fixture_run(tmp_path_factory):
    fx = heldout.load()
    scores, docids = heldout.search(fx, device="cpu")
    run_path = str(tmp_path_factory.mktemp("heldout_run") / "run.tsv")
    return fx, scores, docids, heldout.score_run(fx, scores, docids, run_path)


def test_fixture_reproduces_the_committed_metrics(fixture_run):
    """The port's CPU run over the fixture: the committed metric.json
    exactly, and beside the JAX package's TPU run of the same model
    (docs/heldout_r5/m12_conc_index_dev.json) the same 241 judged queries
    and MRR@10 within the bar set before the port's run."""
    fx, scores, docids, metric = fixture_run
    assert fx["codes"].shape == (200_000, 12) and fx["codes"].dtype == np.uint8
    assert fx["query_embeds"].shape == (241, 768)
    assert fx["centroids"].shape == (12, 256, 64)
    assert scores.shape == docids.shape == (241, heldout.TOPK)
    assert len(metric["perquery"]) == 241
    assert metric == fx["metric"]
    with open(os.path.join(ROOT, "docs", "heldout_r5",
                           "m12_conc_index_dev.json")) as f:
        tpu = json.load(f)
    assert tpu["mrr"]["MRR@10"] == heldout.TPU_MRR10
    out = heldout.compare(metric, tpu)
    assert out["queries"] == 241
    assert abs(out["delta_mrr_at_10"]) <= heldout.MRR10_BAR


def test_fixture_topk_matches_jax(fixture_run):
    """The JAX package's CPU batch_adc_search on the same arrays: ids equal
    except where the swapped docs' float64 scores (fp32 LUT) lie within
    1e-5 of the query's score scale, scores within that scale too."""
    fx, scores, docids, _ = fixture_run
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


@pytest.mark.skipif(not os.environ.get("REPCONC_HELDOUT_DIR"),
                    reason="REPCONC_HELDOUT_DIR (the regenerated corpus and "
                           "the port's eval run over it) is not set")
def test_regenerated_corpus_codes_match_jax(real_model):
    """4,096 docs drawn with a seed from the encode order: the codes of the
    port's eval run equal the JAX package's CPU encode_texts except at
    fp32 near-ties. Prints the counts."""
    from repconc_tpu_torch.eval.run_io import load_corpus

    root = os.environ["REPCONC_HELDOUT_DIR"]
    tok = real_model["tok"]
    config, params = real_model["config"], real_model["params"]
    corpus = load_corpus(os.path.join(root, "data_task", "corpus.tsv"),
                         tok.sep_token)
    codes = np.load(os.path.join(root, "conc_index", "codes.npy"))
    ids = np.load(os.path.join(root, "conc_index", "corpus_ids.npy"))
    assert len(ids) == len(corpus) == 200_000
    rows = np.sort(np.random.default_rng(2022).choice(len(ids), 4096,
                                                      replace=False))
    texts = [corpus[ids[r]] for r in rows]
    kw = dict(batch_size=256, input_text_type="doc")
    want = jax_encode.encode_texts(texts, config, params, tok, 128,
                                   output="code", **kw)
    x = jax_encode.encode_texts(texts, config, params, tok, 128, **kw)
    got = codes[rows]
    gaps = near_tie_gaps(x, params["centroids"], want, got)
    port_x = encode.encode_texts(texts, real_model["model"], tok, 128,
                                 device="cpu", **kw)
    print(f"\nheld-out sample: {len(rows)} docs, {int((got != want).sum())} "
          f"of {got.size} codes differ in {int((got != want).any(1).sum())} "
          f"docs, worst gap {gaps.max() if len(gaps) else 0.0:.3g} of the "
          f"operands' squared norms; embeddings max abs diff "
          f"{float(np.abs(port_x - x).max()):.3g}")
    assert not len(gaps) or gaps.max() <= TIE_BAR
