"""The port's shard-resumable corpus encode (eval/encode.py::encode_corpus
with cache_dir): the counterparts of tests/test_encode_resume.py. A killed
and resumed encode equals an uninterrupted one, complete shards are
trusted, and every shard drops when the params, the corpus or a setting
change."""
import json
import os

import numpy as np
import pytest
import torch

from repconc_tpu.eval import encode as jax_encode
from repconc_tpu.models import repconc_model as jax_model
from repconc_tpu_torch.eval import encode
from repconc_tpu_torch.models.repconc_model import from_dense_encoder

WORDS = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliet", "kilo", "lima", "mike", "november"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """tests/test_encode_resume.py's one-layer BERT wrapped at M=8, K=32,
    in both packages, and its tokenizer."""
    from transformers import (AutoTokenizer, BertConfig, BertModel,
                              BertTokenizerFast)

    torch.manual_seed(11)
    d = tmp_path_factory.mktemp("tiny_bert_resume")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS
    (d / "vocab.txt").write_text("\n".join(vocab))
    BertTokenizerFast(vocab_file=str(d / "vocab.txt"),
                      do_lower_case=True).save_pretrained(d)
    cfg = BertConfig(vocab_size=len(vocab), hidden_size=32, num_hidden_layers=1,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=64, pad_token_id=0)
    cfg.pooling = "mean"
    BertModel(cfg, add_pooling_layer=False).save_pretrained(d)
    model = from_dense_encoder(str(d), MCQ_M=8, MCQ_K=32, device="cpu")
    return model, AutoTokenizer.from_pretrained(str(d)), str(d)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(5)
    return {f"d{i}": " ".join(rng.choice(WORDS, size=int(rng.integers(3, 12))))
            for i in range(100)}


def _encode(model, tok, corpus, **kw):
    kw = dict(dict(max_seq_length=16, batch_size=16,
                   output="continuous_embedding", device="cpu"), **kw)
    return encode.encode_corpus(corpus, model, tok, **kw)


@pytest.mark.parametrize("output", ["continuous_embedding", "code"])
def test_sharded_encode_matches_unsharded(tiny, corpus, tmp_path, output):
    model, tok, _ = tiny
    ref, ref_ids = _encode(model, tok, corpus, output=output)
    out, ids = _encode(model, tok, corpus, output=output,
                       cache_dir=str(tmp_path), shard_size=32)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == ref.dtype
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("shard_")) \
        == [f"shard_{i:06d}.npy" for i in range(4)]  # ceil(100 / 32)


def test_killed_encode_resumes_to_identical_output(tiny, corpus, tmp_path,
                                                   monkeypatch):
    """The encode dies in its third shard; the rerun encodes only the
    shards that were not flushed, and the output equals an uninterrupted
    encode."""
    model, tok, _ = tiny
    ref, _ = _encode(model, tok, corpus)
    real = encode.encode_texts
    calls = []

    def dying(texts, *a, **kw):
        calls.append(len(texts))
        if len(calls) == 3:
            raise KeyboardInterrupt("killed")
        return real(texts, *a, **kw)

    monkeypatch.setattr(encode, "encode_texts", dying)
    with pytest.raises(KeyboardInterrupt):
        _encode(model, tok, corpus, cache_dir=str(tmp_path), shard_size=32)
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("shard_")) \
        == ["shard_000000.npy", "shard_000001.npy"]
    calls.clear()
    monkeypatch.setattr(encode, "encode_texts",
                        lambda texts, *a, **kw: (calls.append(len(texts)),
                                                 real(texts, *a, **kw))[1])
    out, _ = _encode(model, tok, corpus, cache_dir=str(tmp_path), shard_size=32)
    assert calls == [32, 4]
    np.testing.assert_array_equal(out, ref)


def test_resume_trusts_complete_shards(tiny, corpus, tmp_path):
    model, tok, _ = tiny
    kw = dict(cache_dir=str(tmp_path), shard_size=32)
    _encode(model, tok, corpus, **kw)
    sentinel = np.full((32, 32), 7.0, np.float32)
    np.save(tmp_path / "shard_000000.npy", sentinel)
    os.remove(tmp_path / "shard_000002.npy")
    out, _ = _encode(model, tok, corpus, **kw)
    np.testing.assert_array_equal(out[:32], sentinel)
    ref, _ = _encode(model, tok, corpus)
    np.testing.assert_array_equal(out[64:96], ref[64:96])


@pytest.mark.parametrize("change", ["max_seq_length", "output", "shard_size"])
def test_settings_change_invalidates_cache(tiny, corpus, tmp_path, change):
    model, tok, _ = tiny
    kw = dict(cache_dir=str(tmp_path), shard_size=32)
    _encode(model, tok, corpus, **kw)
    np.save(tmp_path / "shard_000000.npy", np.zeros((32, 32), np.float32))
    new = {"max_seq_length": dict(max_seq_length=24),
           "output": dict(output="code"),
           "shard_size": dict(shard_size=50)}[change]
    out, _ = _encode(model, tok, corpus, **dict(kw, **new))
    ref, _ = _encode(model, tok, corpus,
                     **{k: v for k, v in new.items() if k != "shard_size"})
    np.testing.assert_array_equal(out, ref)


def test_batch_size_keeps_the_shards(tiny, corpus, tmp_path):
    """A rerun with a smaller batch (the recovery from running out of
    memory) trusts the finished shards."""
    model, tok, _ = tiny
    kw = dict(cache_dir=str(tmp_path), shard_size=32)
    _encode(model, tok, corpus, **kw)
    sentinel = np.full((32, 32), 7.0, np.float32)
    np.save(tmp_path / "shard_000000.npy", sentinel)
    out, _ = _encode(model, tok, corpus, batch_size=8, **kw)
    np.testing.assert_array_equal(out[:32], sentinel)


def test_model_or_corpus_change_invalidates_cache(tiny, corpus, tmp_path):
    """n, first_id and last_id can all collide: the meta key carries the
    params and corpus fingerprints."""
    model, tok, _ = tiny
    kw = dict(cache_dir=str(tmp_path), shard_size=32)
    _encode(model, tok, corpus, **kw)
    poison = np.full((32, 32), 7.0, np.float32)
    np.save(tmp_path / "shard_000000.npy", poison)
    other = from_dense_encoder(tiny[2], MCQ_M=8, MCQ_K=32, device="cpu")
    with torch.no_grad():  # a few tiny-lr steps' worth of change
        other.encoder.transformer.layers[0].mlp_up.bias.add_(1e-6)
    out, _ = _encode(other, tok, corpus, **kw)
    assert not np.allclose(out[:32], poison)
    assert encode._params_fingerprint(other) != encode._params_fingerprint(model)

    np.save(tmp_path / "shard_000000.npy", poison)
    edited = dict(corpus)
    mid = sorted(edited, key=lambda k: len(edited[k]), reverse=True)[50]
    edited[mid] = edited[mid][:-1] + ("x" if edited[mid][-1] != "x" else "y")
    out2, _ = _encode(other, tok, edited, **kw)
    assert not np.allclose(out2[:32], poison)


def test_corrupt_meta_drops_the_shards(tiny, corpus, tmp_path):
    model, tok, _ = tiny
    kw = dict(cache_dir=str(tmp_path), shard_size=32)
    _encode(model, tok, corpus, **kw)
    np.save(tmp_path / "shard_000000.npy", np.zeros((32, 32), np.float32))
    (tmp_path / "meta.json").write_text("{not json")
    out, _ = _encode(model, tok, corpus, **kw)
    ref, _ = _encode(model, tok, corpus)
    np.testing.assert_array_equal(out, ref)
    assert json.load(open(tmp_path / "meta.json"))["n"] == 100


def test_clear_encode_cache(tiny, corpus, tmp_path):
    model, tok, _ = tiny
    cache = tmp_path / "shards"
    _encode(model, tok, corpus, output="code", cache_dir=str(cache),
            shard_size=64)
    encode.clear_encode_cache(str(cache))
    assert not cache.exists()
    encode.clear_encode_cache(str(cache))  # idempotent
    encode.clear_encode_cache(None)


def test_empty_corpus_with_a_cache(tiny, tmp_path):
    model, tok, _ = tiny
    out, ids = _encode(model, tok, {}, output="code", cache_dir=str(tmp_path))
    assert out.shape == (0, 8) and out.dtype == np.uint8 and len(ids) == 0


def test_cached_encode_matches_jax(tiny, corpus, tmp_path):
    """Shards are the port's own (its fingerprint is over its tensors), and
    the resumed output still equals the JAX package's uncached encode."""
    model, tok, d = tiny
    config, params = jax_model.from_dense_encoder(d, MCQ_M=8, MCQ_K=32)
    want, want_ids = jax_encode.encode_corpus(
        corpus, config, params, tok, max_seq_length=16, batch_size=16,
        output="continuous_embedding")
    kw = dict(cache_dir=str(tmp_path), shard_size=32)
    _encode(model, tok, corpus, **kw)
    os.remove(tmp_path / "shard_000001.npy")
    got, ids = _encode(model, tok, corpus, **kw)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
