"""The port's large-run metrics (repconc_tpu_torch/eval/trec.py::
evaluate_files, taken by evaluate_run for run files above
_NATIVE_MIN_RUN_BYTES) against the JAX package's evaluate_run, which takes
its C++ backend there (repconc_tpu/native/trec_eval.cpp) and its Python
loop below the threshold."""
import numpy as np
import pytest

from repconc_tpu import native
from repconc_tpu.eval import trec as jax_trec
from repconc_tpu_torch.eval import trec

GROUPS = ("ndcg", "map", "recall", "precision", "mrr")


def _write(tmp_path, qrel_lines, run_lines):
    qrel_path, run_path = tmp_path / "qrels.txt", tmp_path / "run.tsv"
    qrel_path.write_text("".join(qrel_lines))
    run_path.write_text("".join(run_lines))
    return str(qrel_path), str(run_path)


def _random_files(tmp_path, seed, nq=60, ndocs=400, per_q=120):
    """Graded qrels (some rel 0 and -1), queries only in the qrels or only
    in the run, scores rounded to force ties, and a repeated line."""
    rng = np.random.default_rng(seed)
    qrels = [f"q{q} 0 d{d} {rng.integers(-1, 4)}\n"
             for q in range(nq + 5)
             for d in rng.choice(ndocs, size=rng.integers(1, 7), replace=False)]
    run = []
    for q in list(range(5, nq)) + [999]:
        docs = rng.choice(ndocs, size=per_q, replace=False)
        scores = np.round(rng.normal(size=per_q), 1)
        for r, j in enumerate(np.argsort(-scores)):
            run.append(f"q{q}\tQ0\td{docs[j]}\t{r + 1}\t{scores[j]}\tSys\n")
    run.append(run[3])
    return _write(tmp_path, qrels, run)


def _assert_metrics_close(got, want):
    for group in GROUPS:
        assert got[group].keys() == want[group].keys()
        for key, v in want[group].items():
            assert abs(got[group][key] - v) < 1e-9, (group, key,
                                                     got[group][key], v)


@pytest.fixture
def dispatch_all(monkeypatch):
    """Both packages' thresholds at 0: every file-path run is large."""
    monkeypatch.setattr(trec, "_NATIVE_MIN_RUN_BYTES", 0)
    monkeypatch.setattr(jax_trec, "_NATIVE_MIN_RUN_BYTES", 0)


@pytest.mark.parametrize("seed,ks,mrr_ks,level", [
    (0, (1, 3, 5, 10, 100), (10, 100), 1),
    (1, (5, 10, 1000), (10,), 2),
    (2, (2, 200), (1, 5, 500), 1),
])
def test_large_run_matches_jax(tmp_path, dispatch_all, seed, ks, mrr_ks,
                               level):
    """Above the threshold: "perquery" is {} and every metric is within
    1e-9 of the JAX package's (its C++ backend where it has a compiler,
    else its Python loop) and of its Python loop on the parsed files."""
    qrel_path, run_path = _random_files(tmp_path, seed)
    got = trec.evaluate_run(qrel_path, run_path, ks, mrr_ks, level)
    assert got["perquery"] == {}
    want = jax_trec.evaluate_run(qrel_path, run_path, ks, mrr_ks, level)
    _assert_metrics_close(got, want)
    parsed = jax_trec.evaluate_run(jax_trec.parse_qrels(qrel_path),
                                   jax_trec.parse_run(run_path), ks, mrr_ks,
                                   level)
    _assert_metrics_close(got, parsed)
    assert got["num_queries"] == len(parsed["perquery"])
    if native.load() is not None:
        assert want["perquery"] == {}
        assert got.keys() == want.keys()
        assert got["num_queries"] == want["num_queries"]


def test_below_threshold_keeps_perquery(tmp_path):
    """Below the threshold, and for dict inputs, the Python loop runs and
    "perquery" is kept, as in the JAX package."""
    qrel_path, run_path = _random_files(tmp_path, 3)
    got = trec.evaluate_run(qrel_path, run_path)
    want = jax_trec.evaluate_run(qrel_path, run_path)
    assert got["perquery"] and got == want
    assert trec.evaluate_run(trec.parse_qrels(qrel_path),
                             trec.parse_run(run_path)) == want


def test_malformed_lines_skipped_not_truncating(tmp_path, dispatch_all):
    """A malformed line is skipped and the lines after it still count; a
    repeated (qid, docid) keeps its last score."""
    qrel_path, run_path = _write(tmp_path, [
        "q1 0 d1 1\n",
        "malformed header line\n",
        "\n",
        "q2 0 d2 1\n",
        "q3 0 d3 x\n",
    ], [
        "q1\tQ0\td1\t1\t0.5\tSys\n",
        "q1\tQ0\td1\t2\t9.9\tSys\n",
        "q1\tQ0\td9\t3\t1.0\tSys\n",
        "bogus line without numeric fields\n",
        "q2\tQ0\td7\tr\t5.0\tSys\n",
        "q2\tQ0\td8\t1\tnot-a-score\tSys\n",
        "q2\tQ0\td2\t1\t1.0\tSys\n",
        "q3\tQ0\td3\t1\t1.0\tSys\n",
    ])
    got = trec.evaluate_run(qrel_path, run_path, (10,), (10,))
    assert got["perquery"] == {} and got["num_queries"] == 2
    assert abs(got["mrr"]["MRR@10"] - 1.0) < 1e-9
    want = jax_trec.evaluate_run({"q1": {"d1": 1}, "q2": {"d2": 1}},
                                 {"q1": {"d1": 9.9, "d9": 1.0},
                                  "q2": {"d2": 1.0}}, (10,), (10,))
    _assert_metrics_close(got, want)
    mod = native.load()
    if mod is not None:
        _assert_metrics_close(got, mod.evaluate_files(
            qrel_path, run_path, (10,), (10,), 1))


@pytest.mark.parametrize("rel_doc,rank", [("d9", 1), ("d10", 2), ("d1", 3)])
def test_ties_broken_by_docid_descending(tmp_path, dispatch_all, rel_doc,
                                         rank):
    """Equal scores rank by docid string DESC ("d9" > "d10" > "d1"), as
    trec_eval and the JAX package rank them."""
    qrel_path, run_path = _write(
        tmp_path, [f"q 0 {rel_doc} 1\n"],
        [f"q\tQ0\t{d}\t1\t2.5\tSys\n" for d in ("d1", "d10", "d9")]
        + ["q\tQ0\td0\t4\t1.0\tSys\n"])
    got = trec.evaluate_run(qrel_path, run_path, (1, 2, 3), (1, 2, 3))
    want = jax_trec.evaluate_run(qrel_path, run_path, (1, 2, 3), (1, 2, 3))
    _assert_metrics_close(got, want)
    for cut in (1, 2, 3):
        expect = 1.0 / rank if rank <= cut else 0.0
        assert abs(got["mrr"][f"MRR@{cut}"] - round(expect, 5)) < 1e-9


def test_graded_gains_and_map_over_all_relevant(tmp_path, dispatch_all):
    """NDCG takes graded gains; MAP and recall divide by every relevant doc
    of the query, retrieved or not; P@k divides by k."""
    qrel_path, run_path = _write(tmp_path, [
        "q 0 a 3\n", "q 0 b 1\n", "q 0 c 2\n", "q 0 z 0\n"], [
        "q\tQ0\tb\t1\t3.0\tSys\n", "q\tQ0\tx\t2\t2.0\tSys\n",
        "q\tQ0\ta\t3\t1.0\tSys\n"])
    got = trec.evaluate_run(qrel_path, run_path, (2, 3), (10,))
    dcg = 1 / np.log2(2) + 3 / np.log2(4)
    idcg = 3 / np.log2(2) + 2 / np.log2(3) + 1 / np.log2(4)
    assert abs(got["ndcg"]["NDCG@3"] - round(dcg / idcg, 5)) < 1e-9
    assert abs(got["map"]["MAP@3"] - round((1 + 2 / 3) / 3, 5)) < 1e-9
    assert abs(got["recall"]["Recall@2"] - round(1 / 3, 5)) < 1e-9
    assert abs(got["precision"]["P@3"] - round(2 / 3, 5)) < 1e-9
    _assert_metrics_close(got, jax_trec.evaluate_run(qrel_path, run_path,
                                                     (2, 3), (10,)))


def test_no_query_in_both(tmp_path, dispatch_all):
    """No query in both files, or an empty run (0 bytes: not above even a
    threshold of 0, so the Python loop, as in the JAX package): every
    metric is 0."""
    qrel_path, run_path = _write(tmp_path, ["q1 0 d 1\n"],
                                 ["q2\tQ0\td\t1\t1.0\tSys\n"])
    got = trec.evaluate_run(qrel_path, run_path, (10,), (10,))
    assert got["num_queries"] == 0 and got["perquery"] == {}
    assert all(v == 0.0 for g in GROUPS for v in got[g].values())
    (tmp_path / "run.tsv").write_text("")
    got = trec.evaluate_run(qrel_path, run_path, (10,), (10,))
    assert got["perquery"] == {}
    assert all(v == 0.0 for g in GROUPS for v in got[g].values())
    _assert_metrics_close(got, jax_trec.evaluate_run(qrel_path, run_path,
                                                     (10,), (10,)))


def test_unreadable_size_takes_the_python_loop(tmp_path, monkeypatch):
    """A run path whose size cannot be read is not large: the Python loop
    runs (and raises on the missing file), as in the JAX package."""
    monkeypatch.setattr(trec, "_NATIVE_MIN_RUN_BYTES", 0)
    qrel_path, _ = _write(tmp_path, ["q 0 d 1\n"], [])
    with pytest.raises(OSError):
        trec.evaluate_run(qrel_path, str(tmp_path / "missing.tsv"))
