"""The port's offline tokenization (eval/encode.py::TokenCache,
cli/run_pretokenize.py, --token_cache_dir) and the tokenizer producer
thread of encode_texts, against the JAX package on the CPU: the
counterparts of tests/test_encode_resume.py's token-cache cases.

A cache's batches equal `tokenize_batch` for any batch size, an encode from
a cache equals one that tokenizes online bit for bit, either package opens
a cache the other built, a stale cache tokenizes online with a warning, and
a failure on either side of the producer's queue surfaces in the caller
and leaves no producer thread behind."""
import json
import logging
import os
import threading

import numpy as np
import pytest
import torch

from repconc_tpu.cli import run_pretokenize as jax_pretokenize
from repconc_tpu.eval import encode as jax_encode
from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu_torch.cli import run_dense_eval as port_dense_cli
from repconc_tpu_torch.cli import run_pretokenize
from repconc_tpu_torch.cli import run_repconc_eval as port_cli
from repconc_tpu_torch.core.profiling import Stopwatch
from repconc_tpu_torch.eval import encode
from repconc_tpu_torch.eval.encode import TokenCache
from repconc_tpu_torch.eval.run_io import load_corpus
from repconc_tpu_torch.models.repconc_model import from_pretrained

WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliet", "kilo", "lima", "mike", "november"]
MAX_LEN = 8  # rows of 3-11 words plus [CLS] and [SEP]: many are cut


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A one-layer BERT as an HF dir, wrapped at M=8, K=32 into a RepCONC
    model dir by the JAX package; both packages' models and the tokenizer."""
    from transformers import (AutoTokenizer, BertConfig, BertModel,
                              BertTokenizerFast)

    torch.manual_seed(11)
    hf = tmp_path_factory.mktemp("tiny_bert_tokens")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    (hf / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizerFast(vocab_file=str(hf / "vocab.txt"),
                      do_lower_case=True).save_pretrained(hf)
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=1,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=64, pad_token_id=0)
    cfg.pooling = "mean"
    BertModel(cfg, add_pooling_layer=False).save_pretrained(hf)
    config, params = jax_model.from_dense_encoder(str(hf), MCQ_M=8, MCQ_K=32)
    model_dir = tmp_path_factory.mktemp("tiny_repconc")
    jax_model.save_pretrained(str(model_dir), config, params,
                              tokenizer_dir=str(hf))
    return dict(hf_dir=str(hf), model_dir=str(model_dir),
                model=from_pretrained(str(model_dir), device="cpu"),
                config=config, params=params,
                tok=AutoTokenizer.from_pretrained(str(hf)))


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    return {f"d{i}": " ".join(rng.choice(WORDS, size=int(rng.integers(1, 12))))
            for i in range(100)}


def _sorted_texts(corpus):
    return [corpus[k] for k in
            sorted(corpus, key=lambda k: len(corpus[k]), reverse=True)]


@pytest.mark.parametrize("batch_size", [7, 16, 33])
def test_batches_equal_tokenize_batch(tiny, corpus, tmp_path, batch_size):
    """Every batch, the short tail included, equals tokenize_batch on the
    same texts: int64 ids and mask at the batch's longest row. Batches
    whose rows are all cut at MAX_LEN and batches narrower than MAX_LEN
    both occur."""
    tok = tiny["tok"]
    texts = _sorted_texts(corpus)
    cache = TokenCache.build(texts, tok, MAX_LEN, str(tmp_path), chunk=13)
    n, widths = len(texts), set()
    for start in range(0, n, batch_size):
        want_ids, want_mask = encode.tokenize_batch(
            tok, texts[start:start + batch_size], MAX_LEN, "doc")
        ids, mask = cache.batch(start, batch_size, n)
        assert ids.dtype == mask.dtype == np.int64
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)
        widths.add(ids.shape[1])
    assert MAX_LEN in widths and min(widths) < MAX_LEN


def test_sharded_slices(tiny, corpus, tmp_path):
    """slice() lines up with encode_corpus's shard windows."""
    tok = tiny["tok"]
    texts = _sorted_texts(corpus)
    shard = TokenCache.build(texts, tok, MAX_LEN, str(tmp_path)).slice(32, 64)
    for start, size in ((5, 8), (24, 16)):  # the second runs past the shard
        want = encode.tokenize_batch(tok, texts[32 + start:min(32 + start
                                                             + size, 64)],
                                     MAX_LEN, "doc")
        for got, ref in zip(shard.batch(start, size, 32), want):
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("output", ["code", "continuous_embedding"])
def test_encode_corpus_with_a_token_cache_is_bit_identical(tiny, corpus,
                                                           tmp_path, output):
    """Codes and embeddings from the cache equal, bit for bit, those that
    tokenize online, with and without shards; and they equal the JAX
    package's encode from its own cache (codes exactly on this toy model,
    embeddings within 1e-5)."""
    model, tok = tiny["model"], tiny["tok"]
    texts = _sorted_texts(corpus)
    tc_dir = str(tmp_path / "tc")
    TokenCache.build(texts, tok, MAX_LEN, tc_dir)
    kw = dict(max_seq_length=MAX_LEN, batch_size=16, output=output,
              device="cpu")
    ref, ref_ids = encode.encode_corpus(corpus, model, tok, **kw)
    out, ids = encode.encode_corpus(corpus, model, tok, token_cache_dir=tc_dir,
                                    **kw)
    sharded, _ = encode.encode_corpus(corpus, model, tok, token_cache_dir=tc_dir,
                                      cache_dir=str(tmp_path / "shards"),
                                      shard_size=32, **kw)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(sharded, ref)
    assert out.dtype == ref.dtype
    want, want_ids = jax_encode.encode_corpus(
        corpus, tiny["config"], tiny["params"], tok, max_seq_length=MAX_LEN,
        batch_size=16, output=output, token_cache_dir=tc_dir)
    np.testing.assert_array_equal(ids, want_ids)
    if output == "code":
        np.testing.assert_array_equal(out, want)
    else:
        np.testing.assert_allclose(out, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fault,warning", [
    ("other_corpus", "stale"), ("other_length", "stale"),
    ("other_tokenizer", "stale"), ("missing", "not built"),
    ("unreadable", "unreadable")])
def test_a_bad_cache_tokenizes_online(tiny, corpus, tmp_path, caplog, fault,
                                      warning):
    """A cache built for another corpus, length or tokenizer, or none, or
    a broken one: a warning, then online tokenization; never its tokens."""
    from transformers import BertTokenizerFast

    model, tok = tiny["model"], tiny["tok"]
    texts = _sorted_texts(corpus)
    tc_dir = str(tmp_path / "tc")
    if fault == "other_corpus":
        TokenCache.build(texts[:50], tok, MAX_LEN, tc_dir)
    elif fault == "other_length":
        TokenCache.build(texts, tok, MAX_LEN + 2, tc_dir)
    elif fault == "other_tokenizer":
        (tmp_path / "vocab.txt").write_text(
            "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                      + WORDS[::-1]))
        other = BertTokenizerFast(vocab_file=str(tmp_path / "vocab.txt"))
        TokenCache.build(texts, other, MAX_LEN, tc_dir)
    elif fault == "unreadable":
        TokenCache.build(texts, tok, MAX_LEN, tc_dir)
        with open(os.path.join(tc_dir, "ids.npy"), "wb") as f:
            f.write(b"not an npy")
    kw = dict(max_seq_length=MAX_LEN, batch_size=16,
              output="continuous_embedding", device="cpu")
    ref, _ = encode.encode_corpus(corpus, model, tok, **kw)
    with caplog.at_level(logging.INFO, logger=encode.logger.name):
        out, _ = encode.encode_corpus(corpus, model, tok,
                                      token_cache_dir=tc_dir, **kw)
    messages = [r.getMessage() for r in caplog.records]
    assert any(warning in m for m in messages), messages
    assert not any("token cache hit" in m for m in messages)
    np.testing.assert_array_equal(out, ref)


def _write_corpus(path, n=60, seed=9):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            title = " ".join(rng.choice(WORDS, size=2))
            body = " ".join(rng.choice(WORDS, size=int(rng.integers(3, 12))))
            f.write(f"d{i}\t{title}\t{body}\n")


@pytest.mark.parametrize("model_kind", ["hf_dir", "model_dir"])
def test_pretokenize_cli_writes_the_jax_clis_bytes(tiny, tmp_path, model_kind):
    """run_pretokenize on a raw HF dir (the clamp from config.json) and on
    a RepCONC model dir: the same ids.npy, lengths.npy and token_meta.json
    bytes as the JAX CLI's, with the eval CLIs' corpus loading and
    longest-first order, so encode_corpus hits the cache and encodes to
    the online output."""
    tok = tiny["tok"]
    corpus_path = str(tmp_path / "corpus.tsv")
    _write_corpus(corpus_path)
    argv = ["--model_name_or_path", tiny[model_kind], "--corpus_path",
            corpus_path, "--max_seq_length", "16", "--chunk", "17"]
    run_pretokenize.main(argv + ["--output_dir", str(tmp_path / "port")])
    jax_pretokenize.main(argv + ["--output_dir", str(tmp_path / "jax")])
    for name in ("ids.npy", "lengths.npy", "token_meta.json"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
    loaded = load_corpus(corpus_path, tok.sep_token)
    assert TokenCache.open(str(tmp_path / "port"), _sorted_texts(loaded), tok,
                           16) is not None
    kw = dict(max_seq_length=16, batch_size=16, output="code", device="cpu")
    out, _ = encode.encode_corpus(loaded, tiny["model"], tok,
                                  token_cache_dir=str(tmp_path / "port"), **kw)
    ref, _ = encode.encode_corpus(loaded, tiny["model"], tok, **kw)
    np.testing.assert_array_equal(out, ref)


def test_pretokenize_clamps_to_the_position_table(tiny, tmp_path):
    """--max_seq_length above max_position_embeddings (64) builds at 64,
    the length encode_texts tokenizes at, and encode_corpus hits it."""
    corpus_path = str(tmp_path / "corpus.tsv")
    _write_corpus(corpus_path)
    run_pretokenize.main(["--model_name_or_path", tiny["model_dir"],
                          "--corpus_path", corpus_path, "--max_seq_length",
                          "512", "--output_dir", str(tmp_path / "tc")])
    meta = json.loads((tmp_path / "tc" / "token_meta.json").read_text())
    assert meta["max_seq_length"] == 64
    loaded = load_corpus(corpus_path, tiny["tok"].sep_token)
    assert TokenCache.open(str(tmp_path / "tc"), _sorted_texts(loaded),
                           tiny["tok"], 64) is not None


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_cache_opens_in_the_other_package(tiny, corpus, tmp_path, writer):
    """A cache either package built opens in the other, its batches are
    the reader's tokenize_batch, and the reader encodes from it to the
    output it gives online."""
    tok = tiny["tok"]
    texts = _sorted_texts(corpus)
    tc_dir = str(tmp_path / "tc")
    build = (jax_encode.TokenCache if writer == "jax" else TokenCache).build
    build(texts, tok, MAX_LEN, tc_dir, chunk=19)
    assert (TokenCache.tokenizer_fingerprint(tok)
            == jax_encode.TokenCache.tokenizer_fingerprint(tok))
    port = TokenCache.open(tc_dir, texts, tok, MAX_LEN)
    jax_side = jax_encode.TokenCache.open(tc_dir, texts, tok, MAX_LEN)
    assert port is not None and jax_side is not None
    ids, mask = port.batch(96, 16, len(texts))  # the tail: 4 real rows
    jax_ids, jax_mask = jax_side.batch(96, 16, len(texts))  # copy-padded
    np.testing.assert_array_equal(ids, jax_ids[:4])
    np.testing.assert_array_equal(mask, jax_mask[:4])
    if writer == "jax":
        kw = dict(max_seq_length=MAX_LEN, batch_size=16, output="code",
                  device="cpu")
        out, _ = encode.encode_corpus(corpus, tiny["model"], tok,
                                      token_cache_dir=tc_dir, **kw)
        ref, _ = encode.encode_corpus(corpus, tiny["model"], tok, **kw)
    else:
        kw = dict(max_seq_length=MAX_LEN, batch_size=16, output="code")
        out, _ = jax_encode.encode_corpus(corpus, tiny["config"],
                                          tiny["params"], tok,
                                          token_cache_dir=tc_dir, **kw)
        ref, _ = jax_encode.encode_corpus(corpus, tiny["config"],
                                          tiny["params"], tok, **kw)
    np.testing.assert_array_equal(out, ref)


class _CountingTokenizer:
    """Wraps a tokenizer, counts its calls and raises on call `fail_on`."""

    def __init__(self, tok, fail_on=None):
        self.tok, self.fail_on, self.calls = tok, fail_on, 0

    def __call__(self, texts, **kw):
        self.calls += 1
        if self.calls == self.fail_on:
            raise ValueError("tokenizer failed mid-corpus")
        return self.tok(texts, **kw)


def _producers():
    return [t for t in threading.enumerate()
            if t.name == encode.PRODUCER_THREAD and t.is_alive()]


@pytest.mark.parametrize("side", ["producer", "consumer"])
def test_a_failure_surfaces_and_leaves_no_producer(tiny, corpus, side,
                                                   monkeypatch):
    """A tokenizer that raises mid-corpus (the producer) or a model call
    that raises (the consumer) surfaces in the caller, and no producer
    thread outlives the call, also one that was blocked on the full
    queue."""
    model, tok = tiny["model"], tiny["tok"]
    texts = _sorted_texts(corpus)
    if side == "producer":
        tok, err = _CountingTokenizer(tok, fail_on=3), ValueError
    else:
        calls = []
        real = type(model).encode_continuous

        def failing(self, *a, **kw):
            calls.append(1)
            if len(calls) == 2:  # the producer has filled the queue by now
                raise RuntimeError("device failed mid-corpus")
            return real(self, *a, **kw)

        monkeypatch.setattr(type(model), "encode_continuous", failing)
        err = RuntimeError
    assert not _producers()
    with pytest.raises(err, match="mid-corpus"):
        encode.encode_texts(texts, model, tok, MAX_LEN, batch_size=4,
                            device="cpu")
    assert not _producers()


def test_the_stopwatch_splits_tokenize_and_device_encode(tiny, corpus,
                                                        tmp_path):
    """tokenize is timed in the producer, device_encode in the caller;
    from a cache the tokenizer is never called."""
    model, tok = tiny["model"], tiny["tok"]
    texts = _sorted_texts(corpus)
    sw = Stopwatch()
    encode.encode_texts(texts, model, tok, MAX_LEN, batch_size=16,
                        device="cpu", stopwatch=sw)
    assert set(sw.totals) == {"tokenize", "device_encode"}
    cache = TokenCache.build(texts, tok, MAX_LEN, str(tmp_path))
    counting = _CountingTokenizer(tok)
    out = encode.encode_texts(texts, model, counting, MAX_LEN, batch_size=16,
                              device="cpu", token_cache=cache)
    assert counting.calls == 0
    np.testing.assert_array_equal(
        out, encode.encode_texts(texts, model, tok, MAX_LEN, batch_size=16,
                                 device="cpu"))


def _toy_files(root, corpus):
    rng = np.random.default_rng(3)
    qids = [f"q{i}" for i in range(12)]
    targets = [f"d{int(j)}" for j in rng.choice(len(corpus), 12, replace=False)]
    with open(root / "corpus.tsv", "w") as f:
        f.writelines(f"{d}\t{t}\n" for d, t in corpus.items())
    with open(root / "queries.tsv", "w") as f:
        f.writelines(f"{q}\t{corpus[d]}\n" for q, d in zip(qids, targets))
    with open(root / "qrels.tsv", "w") as f:
        f.writelines(f"{q} 0 {d} 1\n" for q, d in zip(qids, targets))


@pytest.mark.parametrize("cli", ["run_repconc_eval", "run_dense_eval"])
def test_token_cache_dir_through_the_port_clis(tiny, corpus, tmp_path, caplog,
                                               cli):
    """Both port eval CLIs take --token_cache_dir: the cache is hit, and
    every artifact equals a run that tokenizes online."""
    _toy_files(tmp_path, corpus)
    model = tiny["model_dir"] if cli == "run_repconc_eval" else tiny["hf_dir"]
    run_pretokenize.main(["--model_name_or_path", model, "--corpus_path",
                          str(tmp_path / "corpus.tsv"), "--max_seq_length",
                          "16", "--output_dir", str(tmp_path / "tc")])
    main = (port_cli if cli == "run_repconc_eval" else port_dense_cli).main
    base = ["--model_name_or_path", model,
            "--corpus_path", str(tmp_path / "corpus.tsv"),
            "--query_path", str(tmp_path / "queries.tsv"),
            "--qrel_path", str(tmp_path / "qrels.tsv"),
            "--max_seq_length", "16", "--topk", "10",
            "--per_device_eval_batch_size", "16", "--device", "cpu"]
    if cli == "run_dense_eval":
        base += ["--save_corpus_embed", "--save_query_embed"]

    def run(name, extra):
        out = tmp_path / name
        main(base + ["--out_corpus_dir", str(out), "--out_query_dir",
                     str(out / "dev")] + extra)
        return out

    online = run("online", [])
    with caplog.at_level(logging.INFO, logger=encode.logger.name):
        cached = run("cached", ["--token_cache_dir", str(tmp_path / "tc")])
    assert any("token cache hit" in r.getMessage() for r in caplog.records)
    names = (["codes.npy", "corpus_ids.npy", "dev/codes.npy"]
             if cli == "run_repconc_eval"
             else ["corpus_embeds.npy", "corpus_ids.npy",
                   "dev/query_embeds.npy"])
    for name in names:
        np.testing.assert_array_equal(np.load(cached / name),
                                      np.load(online / name), err_msg=name)
    for name in ("dev/run.tsv", "dev/metric.json"):
        assert (cached / name).read_bytes() == (online / name).read_bytes()
