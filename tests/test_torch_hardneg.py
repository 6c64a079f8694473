"""The port's stage-6 hard-negative miner against the JAX package's:
`eval/run_io.py::iter_run` and `cli/run_extract_hardneg` give the same
tuples and the same JSON bytes on the same run and qrels, and the port's
stage-1 trainer takes that JSON as `run_train_conc --negative`."""
import json

import numpy as np
import pytest

from repconc_tpu.cli import run_extract_hardneg as jax_cli
from repconc_tpu.eval import run_io as jax_run_io
from repconc_tpu_torch.cli import run_extract_hardneg
from repconc_tpu_torch.eval import run_io
from test_torch_eval import make_corpus, toy_model_dir  # noqa: F401


@pytest.fixture
def run_and_qrels(tmp_path):
    """A TREC run of 12 queries over 40 docs, 15 ranks each, with blank
    lines and one query absent from the qrels; qrels with graded and zero
    grades, some judged docs retrieved."""
    rng = np.random.default_rng(9)
    lines, qrels = [], []
    for q in range(12):
        docs = rng.choice(40, size=15, replace=False)
        for rank, d in enumerate(docs, 1):
            lines.append(f"q{q} Q0 d{d} {rank} {20.0 - rank * 0.5:.3f} run\n")
        if q % 4 == 0:
            lines.append("\n")
        if q != 7:
            for d in (docs[0], docs[4], rng.integers(40)):
                qrels.append(f"q{q} 0 d{d} {int(rng.integers(0, 3))}\n")
    (tmp_path / "run.tsv").write_text("".join(lines))
    (tmp_path / "qrels.tsv").write_text("".join(qrels))
    return tmp_path / "run.tsv", tmp_path / "qrels.tsv"


def test_iter_run_matches_jax(run_and_qrels):
    run_path, _ = run_and_qrels
    got = list(run_io.iter_run(str(run_path)))
    assert got == list(jax_run_io.iter_run(str(run_path)))
    assert len(got) == 12 * 15 and got[0][2] == 1


@pytest.mark.parametrize("topk", [1, 5, 100])
def test_extract_hardneg_writes_the_jax_clis_bytes(run_and_qrels, tmp_path,
                                                   topk):
    run_path, qrel_path = run_and_qrels
    outs = {}
    for name, main in (("jax", jax_cli.main),
                       ("port", run_extract_hardneg.main)):
        out = tmp_path / name / "sub" / "hardneg.json"
        main(["--run_path", str(run_path), "--qrel_path", str(qrel_path),
              "--topk", str(topk), "--output_path", str(out)])
        outs[name] = out.read_bytes()
    assert outs["port"] == outs["jax"]
    pools = json.loads(outs["port"])
    assert all(len(p) <= topk for p in pools.values())
    if topk == 100:  # every rank but the judged-relevant docs
        assert len(pools["q7"]) == 15


def test_run_train_conc_trains_on_the_mined_negatives(toy_model_dir,
                                                      tmp_path):
    """Stage 6 then stage 7 on the port: a run over the toy corpus, mined
    to a pool per query, read by QDRelDataset through run_train_conc
    --negative, which trains two steps."""
    from repconc_tpu_torch.cli import run_train_conc
    from repconc_tpu_torch.train.data import QDRelDataset

    rng = np.random.default_rng(4)
    corpus = make_corpus(rng, n=60)
    (tmp_path / "corpus.tsv").write_text(
        "".join(f"{k}\t{v}\n" for k, v in corpus.items()))
    (tmp_path / "queries.tsv").write_text("".join(
        f"q{i}\t{' '.join(corpus[f'd{i}'].split()[:3])}\n"
        for i in range(0, 60, 3)))
    (tmp_path / "qrels.tsv").write_text("".join(
        f"q{i} 0 d{i} 1\n" for i in range(0, 60, 3)))
    (tmp_path / "run.tsv").write_text("".join(
        f"q{i} Q0 d{d} {r} {10 - r} warmup\n" for i in range(0, 60, 3)
        for r, d in enumerate([i] + list(rng.choice(60, 6, replace=False)), 1)))
    neg = tmp_path / "hardneg.json"
    run_extract_hardneg.main(["--run_path", str(tmp_path / "run.tsv"),
                              "--qrel_path", str(tmp_path / "qrels.tsv"),
                              "--topk", "5", "--output_path", str(neg)])
    pools = json.loads(neg.read_text())
    ds = QDRelDataset(str(tmp_path / "qrels.tsv"), str(tmp_path / "queries.tsv"),
                      str(tmp_path / "corpus.tsv"), negative=str(neg),
                      negative_per_query=2)
    for q in ds.qids:
        qid = f"q{3 * q}"
        assert ds.negative[q] == [int(d[1:]) for d in pools[qid]]
        assert f"d{3 * q}" not in pools[qid]
    out = run_train_conc.main([
        "--model_name_or_path", toy_model_dir,
        "--qrel_path", str(tmp_path / "qrels.tsv"),
        "--query_path", str(tmp_path / "queries.tsv"),
        "--corpus_path", str(tmp_path / "corpus.tsv"),
        "--negative", str(neg), "--negative_per_query", "2",
        "--output_dir", str(tmp_path / "out"),
        "--per_device_train_batch_size", "4", "--max_steps", "2",
        "--logging_steps", "1", "--sk_iters", "10", "--device", "cpu"])
    assert out["step"] == 2 and len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
