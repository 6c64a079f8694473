"""The port's eval path against the JAX package: trec_eval-parity metrics,
run IO, bucket padding, the toy end-to-end retrieval of
tests/test_e2e_toy.py, and run_repconc_eval reading caches written by the
other package in both directions."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repconc_tpu.cli import run_repconc_eval as jax_cli
from repconc_tpu.eval import encode as jax_encode
from repconc_tpu.eval import pipeline as jax_pipeline
from repconc_tpu.eval import run_io as jax_run_io
from repconc_tpu.eval import trec as jax_trec
from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu_torch.cli import run_repconc_eval as port_cli
from repconc_tpu_torch.core.config import RepConcConfig
from repconc_tpu_torch.eval import encode, pipeline, run_io, trec
from repconc_tpu_torch.models.convert import from_jax_params

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# the corpus and tokenizer of tests/test_e2e_toy.py
WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliet", "kilo", "lima", "mike", "november"]


def make_corpus(rng, n=200):
    return {f"d{i}": " ".join(rng.choice(WORDS, size=rng.integers(3, 12)))
            for i in range(n)}


@pytest.fixture(scope="module")
def toy_model_dir(tmp_path_factory):
    """A tiny HF BERT (as in test_e2e_toy.py) wrapped into a RepCONC model
    dir by the JAX package: repconc_config.json + params.msgpack +
    tokenizer files."""
    from transformers import BertConfig, BertModel, BertTokenizerFast

    torch.manual_seed(7)
    hf = tmp_path_factory.mktemp("tiny_bert")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    (hf / "vocab.txt").write_text("\n".join(vocab))
    tok = BertTokenizerFast(vocab_file=str(hf / "vocab.txt"), do_lower_case=True)
    tok.save_pretrained(hf)
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=64, pad_token_id=0)
    cfg.pooling = "mean"
    cfg.similarity_metric = "METRIC_COS"
    BertModel(cfg, add_pooling_layer=False).save_pretrained(hf)
    config, params = jax_model.from_dense_encoder(str(hf), MCQ_M=8, MCQ_K=32)
    out = tmp_path_factory.mktemp("toy_model")
    jax_model.save_pretrained(str(out), config, params, tokenizer_dir=str(hf))
    return str(out)


@pytest.fixture(scope="module")
def toy_data():
    rng = np.random.default_rng(2022)
    corpus = make_corpus(rng)
    qids = [f"q{i}" for i in range(20)]
    targets = [f"d{i * 7}" for i in range(20)]
    queries = {q: corpus[d] for q, d in zip(qids, targets)}
    qrels = {q: {d: 1} for q, d in zip(qids, targets)}
    return corpus, queries, qrels


def _port_model(model_dir):
    config, params = jax_model.from_pretrained(model_dir)
    import jax

    return from_jax_params(RepConcConfig(**config.to_dict()),
                           jax.tree.map(np.asarray, params))


def assert_runs_match(got, want, tol=1e-4):
    """Same queries; per query the same ranked scores within tol, and the
    same docids except near-ties: a doc ranked differently has a score in
    `want` within tol of the one it replaced, and a doc missing from
    `want`'s top-k ties with its last entry."""
    assert set(got) == set(want)
    for q in want:
        assert len(got[q]) == len(want[q]), q
        rg = sorted(got[q], key=lambda d: -got[q][d])
        rw = sorted(want[q], key=lambda d: -want[q][d])
        floor = min(want[q].values())
        for dg, dw in zip(rg, rw):
            assert abs(got[q][dg] - want[q][dw]) <= tol, (q, dg, dw)
            if dg == dw:
                continue
            if dg in want[q]:
                assert abs(want[q][dg] - want[q][dw]) <= tol, (q, dg, dw)
            else:
                assert got[q][dg] <= floor + tol, (q, dg, dw)


def test_toy_retrieval_matches_jax(toy_model_dir, toy_data):
    from transformers import AutoTokenizer

    corpus, queries, qrels = toy_data
    tok = AutoTokenizer.from_pretrained(toy_model_dir)
    config, params = jax_model.from_pretrained(toy_model_dir)
    want_run, want_codes, want_cids, want_qids = jax_pipeline.repconc_retrieval(
        config, params, tok, corpus, queries, max_seq_length=32, topk=10,
        encode_batch=32, search_batch=8)
    model = _port_model(toy_model_dir)
    run, codes, cids, qids = pipeline.repconc_retrieval(
        model, tok, corpus, queries, max_seq_length=32, topk=10,
        encode_batch=32, search_batch=8, device="cpu")
    np.testing.assert_array_equal(cids, want_cids)
    np.testing.assert_array_equal(qids, want_qids)
    assert codes.dtype == np.uint8 and codes.shape == want_codes.shape
    assert (codes == want_codes).mean() >= 0.999
    assert_runs_match(run, want_run)
    got_m = pipeline.evaluate_repconc_model(
        model, tok, corpus, queries, qrels, max_seq_length=32,
        encode_batch=32, k_values=(1, 10), mrr_k_values=(10,), device="cpu")
    want_m = jax_pipeline.evaluate_repconc_model(
        config, params, tok, corpus, queries, qrels, max_seq_length=32,
        encode_batch=32, k_values=(1, 10), mrr_k_values=(10,))
    assert got_m == want_m


def test_encode_texts_matches_jax(toy_model_dir, toy_data):
    """Continuous embeddings, batched with a ragged tail, equal JAX's."""
    from transformers import AutoTokenizer

    corpus, _, _ = toy_data
    texts = list(corpus.values())[:45]
    tok = AutoTokenizer.from_pretrained(toy_model_dir)
    config, params = jax_model.from_pretrained(toy_model_dir)
    want = jax_encode.encode_texts(texts, config, params, tok, 32, batch_size=16)
    got = encode.encode_texts(texts, _port_model(toy_model_dir), tok, 32,
                              batch_size=16, device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    empty = encode.encode_texts([], _port_model(toy_model_dir), tok, 32,
                                output="code", device="cpu")
    assert empty.shape == (0, 8) and empty.dtype == np.uint8


def _write_toy_files(tmp_path, corpus, queries, qrels):
    paths = {k: str(tmp_path / f"{k}.tsv") for k in ("corpus", "queries", "qrels")}
    with open(paths["corpus"], "w") as f:
        f.writelines(f"{d}\t{t}\n" for d, t in corpus.items())
    with open(paths["queries"], "w") as f:
        f.writelines(f"{q}\t{t}\n" for q, t in queries.items())
    with open(paths["qrels"], "w") as f:
        f.writelines(f"{q} 0 {d} {r}\n" for q, ds in qrels.items()
                     for d, r in ds.items())
    return paths


def _cli_args(model_dir, paths, cdir, qdir):
    return ["--model_name_or_path", model_dir, "--max_seq_length", "32",
            "--corpus_path", paths["corpus"], "--query_path", paths["queries"],
            "--qrel_path", paths["qrels"], "--out_corpus_dir", str(cdir),
            "--out_query_dir", str(qdir), "--per_device_eval_batch_size", "32",
            "--topk", "10", "--search_batch", "8"]


def _copy_caches(src_c, src_q, dst_c, dst_q):
    os.makedirs(dst_c)
    os.makedirs(dst_q)
    for name in ("codes.npy", "corpus_ids.npy"):
        shutil.copy(os.path.join(src_c, name), dst_c)
    for name in ("codes.npy", "qids.npy"):
        shutil.copy(os.path.join(src_q, name), dst_q)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cli_reads_the_other_packages_caches(toy_model_dir, toy_data, tmp_path,
                                             writer):
    """One package encodes and searches; the other searches its caches and
    writes the same run.tsv."""
    paths = _write_toy_files(tmp_path, *toy_data)
    first = jax_cli.main if writer == "jax" else (
        lambda a: port_cli.main(a + ["--device", "cpu"]))
    second = (lambda a: port_cli.main(a + ["--device", "cpu"])) \
        if writer == "jax" else jax_cli.main
    c1, q1, c2, q2 = (tmp_path / n for n in ("c1", "q1", "c2", "q2"))
    first(_cli_args(toy_model_dir, paths, c1, q1))
    _copy_caches(c1, q1, c2, q2)
    second(_cli_args(toy_model_dir, paths, c2, q2))
    want = trec.parse_run(str(q1 / "run.tsv"))
    got = trec.parse_run(str(q2 / "run.tsv"))
    assert len(got) == 20
    assert_runs_match(got, want)
    for d in (q1, q2):
        assert (d / "metric.json").exists() and (d / "timings.json").exists()


IVF_ARGS = ["--index_type", "ivf", "--nlist", "8", "--nprobe", "4"]


@pytest.mark.parametrize("writer,serving", [
    ("jax", []), ("port", []),
    ("jax", ["--serving", "pallas", "--lut_dtype", "int8"]),
    ("port", ["--serving", "pallas", "--lut_dtype", "int8"])])
def test_cli_ivf_reads_the_other_packages_index(toy_model_dir, toy_data,
                                                tmp_path, writer, serving):
    """--index_type ivf: one package encodes, builds ivf_index.npz and
    searches; the other searches the same caches, reading that index, and
    writes the same run.tsv and metric.json. The default serving (auto) is
    the exact scan on the CPU in both; pallas with the int8 LUT runs JAX's
    kernels in interpret mode and the port's plain K3."""
    paths = _write_toy_files(tmp_path, *toy_data)
    port = lambda a: port_cli.main(a + ["--device", "cpu"])  # noqa: E731
    first, second = (jax_cli.main, port) if writer == "jax" else (port,
                                                                 jax_cli.main)
    c1, q1, c2, q2 = (tmp_path / n for n in ("c1", "q1", "c2", "q2"))
    first(_cli_args(toy_model_dir, paths, c1, q1) + IVF_ARGS + serving)
    _copy_caches(c1, q1, c2, q2)
    shutil.copy(c1 / "ivf_index.npz", c2)
    stamp = os.path.getmtime(c2 / "ivf_index.npz")
    second(_cli_args(toy_model_dir, paths, c2, q2) + IVF_ARGS + serving)
    assert os.path.getmtime(c2 / "ivf_index.npz") == stamp  # read, not rebuilt
    want = trec.parse_run(str(q1 / "run.tsv"))
    got = trec.parse_run(str(q2 / "run.tsv"))
    assert len(got) == 20
    assert_runs_match(got, want)
    with open(q1 / "metric.json") as f1, open(q2 / "metric.json") as f2:
        assert json.load(f2) == json.load(f1)


def test_cli_ivf_rebuilds_a_stale_or_unreadable_index(toy_model_dir, toy_data,
                                                      tmp_path):
    """A cached ivf_index.npz built at another --nlist, or one that does not
    load, is rebuilt at the asked nlist and saved over the old one."""
    from repconc_tpu_torch.index.ivf import IVFIndex

    paths = _write_toy_files(tmp_path, *toy_data)
    cdir, qdir = tmp_path / "c", tmp_path / "q"
    args = _cli_args(toy_model_dir, paths, cdir, qdir) + ["--device", "cpu"]
    port_cli.main(args + IVF_ARGS)
    assert IVFIndex.load(str(cdir)).nlist == 8
    first_run = (qdir / "run.tsv").read_text()
    os.remove(qdir / "metric.json")
    port_cli.main(args + ["--index_type", "ivf", "--nlist", "4"])
    assert IVFIndex.load(str(cdir)).nlist == 4
    (cdir / "ivf_index.npz").write_bytes(b"not an npz")
    os.remove(qdir / "metric.json")
    port_cli.main(args + IVF_ARGS)
    assert IVFIndex.load(str(cdir)).nlist == 8
    assert (qdir / "run.tsv").read_text() == first_run


def test_cli_guards_and_unported_options(toy_model_dir, toy_data, tmp_path):
    paths = _write_toy_files(tmp_path, *toy_data)
    same = _cli_args(toy_model_dir, paths, tmp_path / "x", tmp_path / "x")
    with pytest.raises(SystemExit):
        port_cli.main(same + ["--device", "cpu"])
    base = _cli_args(toy_model_dir, paths, tmp_path / "c", tmp_path / "q")
    # --data_parallel is ported: at world size 1 (a gloo group joined by the
    # env contract) the corpus-sharded search writes the one-process run
    from test_torch_distributed import _ranking, world1_mesh

    one = _cli_args(toy_model_dir, paths, tmp_path / "c1", tmp_path / "q1")
    port_cli.main(one + ["--device", "cpu"])
    with world1_mesh():
        port_cli.main(base + ["--data_parallel", "--device", "cpu"])
    np.testing.assert_array_equal(np.load(tmp_path / "c" / "codes.npy"),
                                  np.load(tmp_path / "c1" / "codes.npy"))
    assert (_ranking(tmp_path / "q" / "run.tsv")
            == _ranking(tmp_path / "q1" / "run.tsv"))
    os.remove(tmp_path / "q" / "metric.json")
    # decoded residency is ported: --serving decoded serves the IVF
    port_cli.main(base + ["--index_type", "ivf", "--nlist", "8", "--nprobe",
                          "8", "--serving", "decoded", "--device", "cpu"])
    assert (tmp_path / "q" / "metric.json").exists()
    # the adapters are ported: the TCT tokenizer runs over the toy vocab
    tct = _cli_args(toy_model_dir, paths, tmp_path / "tc", tmp_path / "tq")
    port_cli.main(tct + ["--adapter", "tct", "--device", "cpu"])
    assert (tmp_path / "tq" / "metric.json").exists()


def test_trec_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(12)
    qrels = {f"q{i}": {f"d{j}": int(rng.integers(0, 3))
                       for j in rng.choice(50, size=6, replace=False)}
             for i in range(15)}
    run = {f"q{i}": {f"d{j}": float(np.round(rng.normal(), 2))  # with ties
                     for j in rng.choice(50, size=30, replace=False)}
           for i in range(17)}
    for level in (1, 2):
        want = jax_trec.evaluate_run(qrels, run, relevance_level=level)
        assert trec.evaluate_run(qrels, run, relevance_level=level) == want
    assert trec.truncate_run(run, 5) == jax_trec.truncate_run(run, 5)
    qids = sorted(run)
    scores = np.array([sorted(run[q].values(), reverse=True)[:10] for q in qids])
    ids = np.array([sorted(run[q], key=lambda d: -run[q][d])[:10] for q in qids])
    scores[0, -1] = -np.inf  # pad sentinel: dropped
    run_io.write_run_tsv(str(tmp_path / "a.tsv"), qids, scores, ids)
    jax_run_io.write_run_tsv(str(tmp_path / "b.tsv"), qids, scores, ids)
    assert (tmp_path / "a.tsv").read_text() == (tmp_path / "b.tsv").read_text()
    qrel_path = os.path.join(FIXTURES, "msmarco", "2019qrels-pass.txt")
    assert trec.parse_qrels(qrel_path) == jax_trec.parse_qrels(qrel_path)
    assert (trec.evaluate_run(qrel_path, str(tmp_path / "a.tsv"))
            == jax_trec.evaluate_run(qrel_path, str(tmp_path / "a.tsv")))
    assert (pipeline.run_from_topk(qids, scores, ids)
            == jax_pipeline.run_from_topk(qids, scores, ids))


def test_run_io_loaders_match_jax():
    ms = os.path.join(FIXTURES, "msmarco")
    beir = os.path.join(FIXTURES, "beir", "scifact")
    assert (run_io.load_corpus(os.path.join(ms, "collection.tsv"), "[SEP]")
            == jax_run_io.load_corpus(os.path.join(ms, "collection.tsv"), "[SEP]"))
    for name in ("queries.dev.small.tsv",):
        p = os.path.join(ms, name)
        assert run_io.load_queries(p) == jax_run_io.load_queries(p)
    p = os.path.join(ms, "qrels.train.tsv")
    assert run_io.load_qrels(p) == jax_run_io.load_qrels(p)
    assert (run_io.load_beir_corpus(os.path.join(beir, "corpus.jsonl"))
            == jax_run_io.load_beir_corpus(os.path.join(beir, "corpus.jsonl")))
    assert (run_io.load_beir_queries(os.path.join(beir, "queries.jsonl"))
            == jax_run_io.load_beir_queries(os.path.join(beir, "queries.jsonl")))
    p = os.path.join(beir, "qrels", "test.tsv")
    assert run_io.load_beir_qrels(p) == jax_run_io.load_beir_qrels(p)


@pytest.mark.parametrize("L,max_len", [(5, 512), (16, 512), (17, 128),
                                       (200, 128), (40, 48)])
def test_pad_to_bucket_matches_jax(L, max_len):
    rng = np.random.default_rng(L)
    ids = rng.integers(1, 100, size=(3, L))
    mask = np.ones_like(ids)
    got = encode.pad_to_bucket(ids, mask, max_len, pad_token_id=1)
    want = jax_encode.pad_to_bucket(ids, mask, max_len, pad_token_id=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
