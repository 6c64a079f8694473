"""Dense eval on the port (index/flat.py, eval/pipeline.py::
evaluate_dense_model, cli/run_dense_eval.py) against the JAX package:
scores within 1e-5, ids equal but for the order of tied scores, the same
metrics and the same artifacts."""
import json

import numpy as np
import pytest
import torch

from repconc_tpu.cli import run_dense_eval as jax_cli
from repconc_tpu.eval import pipeline as jax_pipeline
from repconc_tpu.index import flat as jax_flat
from repconc_tpu.models import auto as jax_auto
from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu_torch.cli import run_dense_eval as port_cli
from repconc_tpu_torch.eval import pipeline
from repconc_tpu_torch.index import flat
from repconc_tpu_torch.models.repconc_model import from_dense_encoder

WORDS = [f"w{i:02d}" for i in range(30)]


def assert_topk_match(s, i, want_s, want_i, tol=1e-5):
    """Scores within tol; ids equal where no other returned score lies
    within tol (the order among tied scores is free)."""
    np.testing.assert_allclose(s, want_s, rtol=0, atol=tol)
    for q in range(len(s)):
        for j in np.nonzero(i[q] != want_i[q])[0]:
            assert (np.abs(want_s[q] - s[q, j]) <= tol).sum() > 1, (q, j)
        assert set(i[q][s[q] > want_s[q, -1] + tol]) <= set(want_i[q])


@pytest.mark.parametrize("N,topk,chunk,ties", [
    (1000, 50, 1 << 20, False),   # one chunk
    (1000, 50, 128, False),       # chunked, a short tail chunk
    (40, 100, 16, False),         # topk > N
    (600, 30, 100, True)])        # duplicated docs: exact ties
def test_flat_search_matches_jax(rng, N, topk, chunk, ties):
    d = 24
    corpus = rng.normal(size=(N, d)).astype(np.float32)
    if ties:
        corpus[N // 2:] = corpus[:N - N // 2]
    queries = rng.normal(size=(37, d)).astype(np.float32)
    want_s, want_i = jax_flat.flat_search(queries, corpus, topk=topk,
                                          chunk_size=chunk)
    s, i = flat.flat_search(queries, corpus, topk=topk, chunk_size=chunk,
                            device="cpu")
    assert s.shape == i.shape == (37, min(topk, N))
    assert_topk_match(s, i, want_s, want_i)
    # a corpus already on the device gives the same result
    s2, i2 = flat.flat_search(queries, torch.from_numpy(corpus), topk=topk,
                              chunk_size=chunk, device="cpu")
    np.testing.assert_array_equal(s2, s)
    np.testing.assert_array_equal(i2, i)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_batch_flat_search_matches_jax(rng, as_tensor, monkeypatch):
    corpus = rng.normal(size=(700, 16)).astype(np.float32)
    queries = rng.normal(size=(130, 16)).astype(np.float32)
    qids = np.array([f"q{j}" for j in range(130)])
    cids = np.array([f"d{j}" for j in range(700)])
    want_s, want_d = jax_flat.batch_flat_search(qids, queries, cids, corpus,
                                                topk=20, batch_size=48)
    if not as_tensor:  # the streaming branch, as above PIN_BYTES
        monkeypatch.setattr(flat, "PIN_BYTES", 0)
    s, d = flat.batch_flat_search(
        qids, queries, cids, torch.from_numpy(corpus) if as_tensor else corpus,
        topk=20, batch_size=48, chunk_size=256, device="cpu")
    row = {c: j for j, c in enumerate(cids)}
    to_rows = np.vectorize(row.get)
    assert_topk_match(s, to_rows(d), want_s, to_rows(want_d))
    s0, d0 = flat.batch_flat_search(qids[:0], queries[:0], cids, corpus,
                                    topk=20, device="cpu")
    assert s0.shape == (0, 20) and d0.shape == (0, 20)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """tests/test_cli_pipeline.py's toy BERT (mean pooling, METRIC_COS
    stamped) and data files."""
    from transformers import BertConfig, BertModel, BertTokenizerFast

    torch.manual_seed(11)
    root = tmp_path_factory.mktemp("dense_eval")
    model_dir = root / "model"
    model_dir.mkdir()
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    (model_dir / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizerFast(vocab_file=str(model_dir / "vocab.txt")).save_pretrained(
        model_dir)
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=64, pad_token_id=0)
    cfg.pooling = "mean"
    cfg.similarity_metric = "METRIC_COS"
    BertModel(cfg, add_pooling_layer=False).save_pretrained(model_dir)
    rng = np.random.default_rng(5)
    corpus = {f"d{i}": f"{WORDS[i % 15]} " + " ".join(
        rng.choice(WORDS[15:], size=int(rng.integers(2, 9)))) for i in range(120)}
    queries = {f"q{i}": WORDS[i % 15] for i in range(30)}
    qrels = {f"q{i}": {f"d{j}": 1 for j in range(120) if j % 15 == i % 15}
             for i in range(30)}
    with open(root / "corpus.tsv", "w") as f:
        f.writelines(f"{d}\t{t}\n" for d, t in corpus.items())
    with open(root / "queries.tsv", "w") as f:
        f.writelines(f"{q}\t{t}\n" for q, t in queries.items())
    with open(root / "qrels.txt", "w") as f:
        f.writelines(f"{q} 0 {d} {r}\n" for q, ds in qrels.items()
                     for d, r in ds.items())
    return root, corpus, queries, qrels


def test_evaluate_dense_model_matches_jax(toy):
    from transformers import AutoTokenizer

    root, corpus, queries, qrels = toy
    tok = AutoTokenizer.from_pretrained(str(root / "model"))
    model = from_dense_encoder(str(root / "model"), MCQ_M=1, device="cpu")
    config, params = jax_model.from_dense_encoder(str(root / "model"), MCQ_M=1)
    kw = dict(max_seq_length=32, topk=10, encode_batch=16, k_values=(1, 10),
              mrr_k_values=(10,))
    want = jax_pipeline.evaluate_dense_model(config, params, tok, corpus,
                                             queries, qrels, **kw)
    got = pipeline.evaluate_dense_model(model, tok, corpus, queries, qrels,
                                        device="cpu", **kw)
    assert got == want


def _cli_args(root, out):
    return ["--model_name_or_path", str(root / "model"),
            "--corpus_path", str(root / "corpus.tsv"),
            "--query_path", str(root / "queries.tsv"),
            "--qrel_path", str(root / "qrels.txt"),
            "--out_corpus_dir", str(out), "--out_query_dir", str(out / "dev"),
            "--max_seq_length", "32", "--topk", "20",
            "--per_device_eval_batch_size", "16"]


def _read_run(path):
    out = {}
    for line in open(path):
        q, _, d, rank, score, _ = line.split()
        out.setdefault(q, []).append((d, int(rank), float(score)))
    return out


def test_cli_artifacts_match_jax(toy, tmp_path):
    root = toy[0]
    save = ["--save_corpus_embed", "--save_query_embed"]
    jax_cli.main(_cli_args(root, tmp_path / "jax") + save)
    port_cli.main(_cli_args(root, tmp_path / "port") + save
                  + ["--device", "cpu"])
    jx, pt = tmp_path / "jax", tmp_path / "port"
    assert not (pt / "encode_shards").exists()
    for name in ("corpus_ids.npy", "dev/qids.npy"):
        np.testing.assert_array_equal(np.load(pt / name), np.load(jx / name))
    for name in ("corpus_embeds.npy", "dev/query_embeds.npy"):
        got = np.load(pt / name)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, np.load(jx / name), rtol=0, atol=1e-5)
    # the embeddings are the encoder's pooled output, unrotated: unit norm
    # under METRIC_COS
    np.testing.assert_allclose(
        np.linalg.norm(np.load(pt / "corpus_embeds.npy"), axis=1), 1.0,
        rtol=1e-5)
    got, want = _read_run(pt / "dev" / "run.tsv"), _read_run(jx / "dev" / "run.tsv")
    assert set(got) == set(want)
    for q in want:
        assert [r for _, r, _ in got[q]] == [r for _, r, _ in want[q]]
        gs = np.array([s for *_, s in got[q]])
        ws = np.array([s for *_, s in want[q]])
        gi = np.array([int(d[1:]) for d, *_ in got[q]])
        wi = np.array([int(d[1:]) for d, *_ in want[q]])
        assert_topk_match(gs[None], gi[None], ws[None], wi[None])
    assert (json.load(open(pt / "dev" / "metric.json"))
            == json.load(open(jx / "dev" / "metric.json")))

    # every artifact is skip-if-exists: a rerun changes nothing
    before = (pt / "dev" / "run.tsv").read_bytes()
    port_cli.main(_cli_args(root, pt) + save + ["--device", "cpu"])
    assert (pt / "dev" / "run.tsv").read_bytes() == before


def test_cli_without_saving_keeps_the_shards_as_the_cache(toy, tmp_path):
    root = toy[0]
    port_cli.main(_cli_args(root, tmp_path) + ["--device", "cpu"])
    assert (tmp_path / "encode_shards" / "meta.json").exists()
    assert not (tmp_path / "corpus_embeds.npy").exists()
    assert (tmp_path / "dev" / "metric.json").exists()


def test_cli_metric_and_pooling_overrides_match_jax(toy, tmp_path):
    """--similarity_metric METRIC_CENTROID_COS ranks by inner product and
    --pooling cls takes the first token, in both packages."""
    root = toy[0]
    extra = ["--similarity_metric", "METRIC_CENTROID_COS", "--pooling", "cls",
             "--save_corpus_embed"]
    jax_cli.main(_cli_args(root, tmp_path / "jax") + extra)
    port_cli.main(_cli_args(root, tmp_path / "port") + extra
                  + ["--device", "cpu"])
    got = np.load(tmp_path / "port" / "corpus_embeds.npy")
    np.testing.assert_allclose(
        got, np.load(tmp_path / "jax" / "corpus_embeds.npy"), rtol=0, atol=1e-5)
    assert not np.allclose(np.linalg.norm(got, axis=1), 1.0)


@pytest.mark.parametrize("extra,item", [(["--data_parallel"], "item 10")])
def test_cli_unported_options_raise(toy, tmp_path, extra, item):
    """Options that were ROADMAP.md Queue 1 `item`, since ported:
    --data_parallel at world size 1 (a gloo group joined by the env
    contract) encodes over the mesh and searches a ShardedFlatIndex, and
    writes the one-process embeddings and run (but for the order of exact
    ties)."""
    from test_torch_distributed import _ranking, world1_mesh

    one, dp = tmp_path / "one", tmp_path / "dp"
    port_cli.main(_cli_args(toy[0], one) + ["--save_query_embed", "--device",
                                             "cpu"])
    with world1_mesh():
        port_cli.main(_cli_args(toy[0], dp) + extra + ["--save_query_embed",
                                                        "--device", "cpu"])
    np.testing.assert_array_equal(np.load(dp / "dev" / "query_embeds.npy"),
                                  np.load(one / "dev" / "query_embeds.npy"))
    assert (_ranking(dp / "dev" / "run.tsv")
            == _ranking(one / "dev" / "run.tsv"))
    assert (dp / "dev" / "metric.json").exists()


def test_cli_default_device_needs_a_card(toy, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        port_cli.main(_cli_args(toy[0], tmp_path))


def test_jax_dir_loads_in_the_port(toy):
    """The toy HF dir through both packages' load_dense_encoder: the same
    config and metric."""
    from repconc_tpu_torch.models import auto

    root = toy[0]
    cfg, _, metric = auto.load_dense_encoder(str(root / "model"), device="cpu")
    jax_cfg, _, jax_metric = jax_auto.load_dense_encoder(str(root / "model"))
    assert metric == jax_metric == "METRIC_COS"
    assert cfg.pooling == jax_cfg.pooling == "mean"
