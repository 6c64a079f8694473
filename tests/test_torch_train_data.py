"""The port's copy of the training data pipeline against
repconc_tpu.train.data: the same files and seed give the same batches,
key for key and value for value."""
import json
import random

import numpy as np
import pytest

from repconc_tpu.train import data as jax_data
from repconc_tpu_torch.train import data


@pytest.fixture(scope="module")
def toy_files(tmp_path_factory):
    """tests/test_data.py's files, plus a query with three positives and a
    qrel line whose doc is not in the corpus."""
    d = tmp_path_factory.mktemp("toydata")
    (d / "queries.tsv").write_text(
        "".join(f"q{i}\twhat is item {i}\n" for i in range(20)))
    (d / "corpus.tsv").write_text(
        "".join(f"d{i}\ttitle {i}\tbody text about item {i}\n" for i in range(50)))
    qrel_lines = []
    for i in range(20):
        qrel_lines.append(f"q{i} 0 d{i} 1\n")
        if i < 5:
            qrel_lines.append(f"q{i} 0 d{i + 30} 1\n")
    qrel_lines += ["q7 0 d40 1\n", "q7 0 d41 1\n", "q3 0 d99 1\n"]
    (d / "qrels.txt").write_text("".join(qrel_lines))
    hardneg = {f"q{i}": [f"d{(i + 7) % 50}", f"d{(i + 9) % 50}",
                         f"d{(i + 11) % 50}"] for i in range(0, 20, 2)}
    hardneg["q1"] = ["d5"]  # a pool smaller than negative_per_query
    (d / "hardneg.json").write_text(json.dumps(hardneg))
    return d


@pytest.fixture(scope="module")
def tokenizer(tmp_path_factory):
    from transformers import BertTokenizerFast

    d = tmp_path_factory.mktemp("tok")
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + \
        ["what", "is", "item", "title", "body", "text", "about"] + \
        [str(i) for i in range(50)]
    (d / "vocab.txt").write_text("\n".join(vocab))
    return BertTokenizerFast(vocab_file=str(d / "vocab.txt"))


def _batches(module, toy_files, tokenizer, negative, n_neg, n_batches,
             batch_size=4, max_positives=2, drop_last=True):
    neg = str(toy_files / "hardneg.json") if negative == "json" else negative
    ds = module.QDRelDataset(str(toy_files / "qrels.txt"),
                             str(toy_files / "queries.tsv"),
                             str(toy_files / "corpus.tsv"), negative=neg,
                             negative_per_query=n_neg)
    coll = module.FinetuneCollator(tokenizer, 8, 16,
                                   max_positives=max_positives)
    it = module.batch_iterator(ds, coll, batch_size, num_epochs=2, seed=7,
                               drop_last=drop_last)
    return [b for _, b in zip(range(n_batches), it)]


@pytest.mark.parametrize("negative,n_neg,drop_last", [
    ("random", 2, True), ("inbatch", 0, True), ("json", 2, True),
    ("random", 1, False)])
def test_batches_match_jax(toy_files, tokenizer, negative, n_neg, drop_last):
    """Same seed, same batches across two epochs: every key, dtype and
    value, the hard-negative pools (with the degenerate one-doc pool and
    the random fallback) and the truncated positives included."""
    want = _batches(jax_data, toy_files, tokenizer, negative, n_neg, 12,
                    batch_size=3, drop_last=drop_last)
    got = _batches(data, toy_files, tokenizer, negative, n_neg, 12,
                   batch_size=3, drop_last=drop_last)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert ("neg_input_ids" in g) == (n_neg > 0)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_query_dataset_and_collator_match_jax(toy_files, tokenizer):
    index_ids = np.array([f"d{i}" for i in range(0, 50, 2)])
    args = (str(toy_files / "qrels.txt"), str(toy_files / "queries.tsv"),
            index_ids)
    want_ds, got_ds = jax_data.QueryDataset(*args), data.QueryDataset(*args)
    assert got_ds.qids == want_ds.qids and got_ds.qrels == want_ds.qrels
    want_s = [want_ds.sample(q, random.Random(q)) for q in want_ds.qids]
    got_s = [got_ds.sample(q, random.Random(q)) for q in got_ds.qids]
    assert got_s == want_s
    want = jax_data.QueryCollator(tokenizer, 8, max_positives=3)(
        want_s, want_ds.qrels)
    got = data.QueryCollator(tokenizer, 8, max_positives=3)(got_s, got_ds.qrels)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_padded_positives_keeps_the_sampled_one_first():
    qrels = {0: [5, 6, 7], 1: [9]}
    samples = [{"qid": 0, "pos_docid": 7}, {"qid": 1, "pos_docid": 9}]
    got = data.padded_positives(samples, qrels, 2)
    np.testing.assert_array_equal(got, [[7, 5], [9, -1]])
    np.testing.assert_array_equal(
        got, jax_data.padded_positives(samples, qrels, 2))
