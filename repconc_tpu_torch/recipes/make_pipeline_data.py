"""Offline workspaces for the port's pipeline recipe: data and a seeded
BERT model dir, with numpy, torch and the standard library only.

    python -m repconc_tpu_torch.recipes.make_pipeline_data toy --out_dir WS
    python -m repconc_tpu_torch.recipes.make_pipeline_data synth --out_dir WS \\
        [--n_docs 200000 --hidden_layers 12 --hidden_size 768 ...]
    python -m repconc_tpu_torch.recipes.make_pipeline_data complete-qrels \\
        --data_dir WS/data [--splits train,dev.small]
    python -m repconc_tpu_torch.recipes.make_pipeline_data split-heldout \\
        WS/data OUT_ROOT
    python -m repconc_tpu_torch.recipes.make_pipeline_data beir \\
        --data_dir WS/data --split dev.small --out_dir BEIR_DIR

The counterparts of recipes/toy/make_toy_data.py (`toy`: 40 words, 20
topics, 2,000 docs, a 2-layer 64-wide BERT) and
recipes/synthetic/make_synth_data.py (`synth`: topics x subtopics, a
vocabulary of 7,905 words at the defaults, bert-base widths), which need
`transformers`. For the same arguments each mode writes the same
corpus.tsv, queries.{train,dev.small}.tsv, qrels.{train,dev.small}.tsv and
vocab.txt byte for byte, and the tokenizer files HF's BertTokenizerFast
saves (tokenizer.json, tokenizer_config.json, special_tokens_map.json).
`complete-qrels` and `split-heldout` are recipes/synthetic/complete_qrels.py
and split_queries_heldout.py (standard library only there too): the same
files, byte for byte, for the same arguments. `beir` copies one split of a
workspace into the BEIR layout that `run_repconc_eval --data_format beir`
reads (corpus.jsonl, queries.jsonl, qrels/test.tsv), so that both formats
encode the same strings: each doc's text is its fields joined by the
tokenizer's separator, as the msmarco loader joins them, under an empty
title, and the docs keep corpus.tsv's order.

The model dir holds config.json and model.safetensors (core/safetensors_io.py)
at the widths asked for: HF's BertModel and the port's load_dense_encoder
both load it. Its weights are drawn from a torch.Generator seeded with the
seed (N(0, 0.02) for every Linear and Embedding weight, zero biases, unit
LayerNorms): random as the JAX makers' are, but not equal to BertModel's
own initialisation of the same seed.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
from collections import defaultdict

import numpy as np
import torch

TOY_WORDS = [f"w{i:02d}" for i in range(40)]
SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


# -- the model dir ---------------------------------------------------------------

def bert_config(vocab_size: int, hidden_size: int, layers: int, heads: int,
                intermediate_size: int, max_positions: int) -> dict:
    """config.json of a bare BertModel at these widths (BertConfig's keys)."""
    return {"architectures": ["BertModel"],
            "attention_probs_dropout_prob": 0.1, "classifier_dropout": None,
            "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
            "hidden_size": hidden_size, "initializer_range": 0.02,
            "intermediate_size": intermediate_size, "layer_norm_eps": 1e-12,
            "max_position_embeddings": max_positions, "model_type": "bert",
            "num_attention_heads": heads, "num_hidden_layers": layers,
            "pad_token_id": 0, "position_embedding_type": "absolute",
            "type_vocab_size": 2, "use_cache": True, "vocab_size": vocab_size}


def _dump(obj) -> str:
    return json.dumps(obj, indent=2, ensure_ascii=False)


def tokenizer_files(vocab) -> dict:
    """{file name: text} of what HF's BertTokenizerFast(vocab_file=...)
    .save_pretrained writes for `vocab` (uncased, [CLS] A [SEP])."""
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(vocab) if t in SPECIALS]
    ids = {t: i for i, t in enumerate(vocab)}

    def special(tok, type_id):
        return {"SpecialToken": {"id": tok, "type_id": type_id}}

    def seq(name, type_id):
        return {"Sequence": {"id": name, "type_id": type_id}}

    tokenizer = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [special("[CLS]", 0), seq("A", 0), special("[SEP]", 0)],
            "pair": [special("[CLS]", 0), seq("A", 0), special("[SEP]", 0),
                     seq("B", 1), special("[SEP]", 1)],
            "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]}
                               for t in ("[CLS]", "[SEP]")}},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": ids}}
    config = {
        "added_tokens_decoder": {
            str(a["id"]): {k: a[k] for k in ("content", "lstrip", "normalized",
                                             "rstrip", "single_word", "special")}
            for a in added},
        "clean_up_tokenization_spaces": True, "cls_token": "[CLS]",
        "do_basic_tokenize": True, "do_lower_case": True,
        "extra_special_tokens": {}, "mask_token": "[MASK]",
        "model_max_length": int(1e30), "never_split": None,
        "pad_token": "[PAD]", "sep_token": "[SEP]", "strip_accents": None,
        "tokenize_chinese_chars": True, "tokenizer_class": "BertTokenizer",
        "unk_token": "[UNK]"}
    specials_map = {"cls_token": "[CLS]", "mask_token": "[MASK]",
                    "pad_token": "[PAD]", "sep_token": "[SEP]",
                    "unk_token": "[UNK]"}
    return {"vocab.txt": "".join(t + "\n" for t in vocab),
            "tokenizer.json": _dump(tokenizer),
            "tokenizer_config.json": _dump(config) + "\n",
            "special_tokens_map.json": _dump(specials_map) + "\n"}


def write_model_dir(model_dir: str, vocab, hidden_size: int, layers: int,
                    heads: int, intermediate_size: int, max_positions: int,
                    seed: int) -> None:
    """A BERT model dir: config.json, seeded model.safetensors and the
    tokenizer files of `vocab`."""
    from repconc_tpu_torch.core import safetensors_io
    from repconc_tpu_torch.models.auto import (encoder_config_from_hf,
                                               export_hf_weights)
    from repconc_tpu_torch.models.transformer import DenseEncoder

    os.makedirs(model_dir, exist_ok=True)
    hf = bert_config(len(vocab), hidden_size, layers, heads,
                     intermediate_size, max_positions)
    cfg = encoder_config_from_hf(hf)
    encoder = DenseEncoder(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in encoder.modules():
            if isinstance(module, (torch.nn.Linear, torch.nn.Embedding)):
                module.weight.copy_(torch.randn(module.weight.shape,
                                                generator=g) * 0.02)
                if getattr(module, "bias", None) is not None:
                    module.bias.zero_()
            elif isinstance(module, torch.nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
    safetensors_io.save_file(export_hf_weights(encoder.state_dict(), cfg),
                             os.path.join(model_dir, "model.safetensors"),
                             metadata={"format": "pt"})
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        f.write(_dump(hf) + "\n")
    for name, text in tokenizer_files(vocab).items():
        with open(os.path.join(model_dir, name), "w", encoding="utf-8") as f:
            f.write(text)


# -- toy -------------------------------------------------------------------------

def make_toy(out_dir: str, n_docs: int = 2000, n_queries: int = 200) -> None:
    """recipes/toy/make_toy_data.py's workspace."""
    write_model_dir(os.path.join(out_dir, "models", "toy-bert"),
                    SPECIALS + TOY_WORDS, hidden_size=64, layers=2, heads=4,
                    intermediate_size=128, max_positions=64, seed=0)
    data_dir = os.path.join(out_dir, "data")
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    n_topics = 20
    with open(os.path.join(data_dir, "corpus.tsv"), "w") as f:
        for i in range(n_docs):
            filler = " ".join(rng.choice(TOY_WORDS[n_topics:], size=6))
            f.write(f"d{i}\ttitle {TOY_WORDS[i % n_topics]}\t{filler}\n")
    for split, n in (("train", n_queries), ("dev.small", 50)):
        with open(os.path.join(data_dir, f"queries.{split}.tsv"), "w") as f:
            for i in range(n):
                f.write(f"{split[:1]}q{i}\t{TOY_WORDS[i % n_topics]}\n")
        with open(os.path.join(data_dir, f"qrels.{split}.tsv"), "w") as f:
            for i in range(n):
                for j in range(n_docs):
                    if j % n_topics == i % n_topics and (j // n_topics) % 7 == 0:
                        f.write(f"{split[:1]}q{i} 0 d{j} 1\n")
    print(f"toy workspace at {out_dir}")


# -- synth -----------------------------------------------------------------------

def _write_corpus_vectorized(data_dir, rng, doc_sub, sub_words, topic_words,
                             noise_words, subtopics_per_topic,
                             chunk: int = 200_000):
    """make_synth_data.py's writer above 500,000 docs: the same draws in the
    same order, word columns fixed, space-padded fixed-width byte columns."""
    n = len(doc_sub)
    sub_arr = np.array(sub_words)
    top_arr = np.array(topic_words)
    noise_arr = np.array(noise_words)
    width = max(sub_arr.dtype.itemsize, top_arr.dtype.itemsize,
                noise_arr.dtype.itemsize) // 4 + 1
    with open(os.path.join(data_dir, "corpus.tsv"), "wb") as f:
        for start in range(0, n, chunk):
            stop = min(start + chunk, n)
            m = stop - start
            subs = doc_sub[start:stop]
            tops = subs // subtopics_per_topic
            cols = []
            for _ in range(6):
                cols.append(sub_arr[subs, rng.integers(0, 3, size=m)])
            for _ in range(10):
                cols.append(top_arr[tops, rng.integers(0, 4, size=m)])
            for _ in range(32):
                cols.append(noise_arr[rng.integers(0, len(noise_arr), size=m)])
            body = np.zeros((m, len(cols)), dtype=f"S{width}")
            for j, c in enumerate(cols):
                body[:, j] = np.char.ljust(c.astype("S"), width)
            body_flat = body.view(f"S{width * len(cols)}").reshape(m)
            ids = np.char.add("d", np.arange(start, stop).astype("U")).astype("S")
            title = np.char.add(np.char.add(sub_arr[subs, 0].astype("S"), b" "),
                                top_arr[tops, 0].astype("S"))
            line = np.char.add(np.char.add(ids, b"\t"), title)
            line = np.char.add(np.char.add(line, b"\t"), body_flat)
            line = np.char.add(np.char.rstrip(line), b"\n")
            f.write(b"".join(line.tolist()))
            print(f"corpus: {stop}/{n}", flush=True)


def make_synth(out_dir: str, n_docs: int = 200_000, n_train_queries: int = 4000,
               n_dev_queries: int = 500, n_topics: int = 100,
               subtopics_per_topic: int = 20, judged_per_query: int = 4,
               hidden_layers: int = 12, hidden_size: int = 768,
               seed: int = 0) -> None:
    """recipes/synthetic/make_synth_data.py's workspace."""
    rng = np.random.default_rng(seed)
    n_sub = n_topics * subtopics_per_topic
    sub_words = [f"sub{i:04d}a sub{i:04d}b sub{i:04d}c".split()
                 for i in range(n_sub)]
    topic_words = [f"top{i:03d}a top{i:03d}b top{i:03d}c top{i:03d}d".split()
                   for i in range(n_topics)]
    noise_words = [f"noise{i:04d}" for i in range(1500)]
    vocab = (SPECIALS + [w for ws in sub_words for w in ws]
             + [w for ws in topic_words for w in ws] + noise_words)
    write_model_dir(os.path.join(out_dir, "models", "synth-bert-base"), vocab,
                    hidden_size=hidden_size, layers=hidden_layers,
                    heads=hidden_size // 64, intermediate_size=4 * hidden_size,
                    max_positions=512, seed=seed)

    data_dir = os.path.join(out_dir, "data")
    os.makedirs(data_dir, exist_ok=True)
    doc_sub = rng.integers(0, n_sub, size=n_docs)
    if n_docs <= 500_000:
        with open(os.path.join(data_dir, "corpus.tsv"), "w") as f:
            for i in range(n_docs):
                s = int(doc_sub[i])
                t = s // subtopics_per_topic
                words = (list(rng.choice(sub_words[s], size=6))
                         + list(rng.choice(topic_words[t], size=10))
                         + list(rng.choice(noise_words, size=32)))
                rng.shuffle(words)
                title = f"{sub_words[s][0]} {topic_words[t][0]}"
                f.write(f"d{i}\t{title}\t{' '.join(words)}\n")
    else:
        _write_corpus_vectorized(data_dir, rng, doc_sub, sub_words,
                                 topic_words, noise_words, subtopics_per_topic)

    by_sub = [[] for _ in range(n_sub)]
    for i, s in enumerate(doc_sub):
        by_sub[s].append(i)
    for split, n in (("train", n_train_queries), ("dev.small", n_dev_queries)):
        with open(os.path.join(data_dir, f"queries.{split}.tsv"), "w") as qf, \
                open(os.path.join(data_dir, f"qrels.{split}.tsv"), "w") as rf:
            for i in range(n):
                s = int(rng.integers(0, n_sub))
                while not by_sub[s]:
                    s = int(rng.integers(0, n_sub))
                t = s // subtopics_per_topic
                qid = f"{split[:1]}q{i}"
                q_words = list(rng.choice(sub_words[s], size=2)) + \
                    [topic_words[t][int(rng.integers(0, 4))]]
                qf.write(f"{qid}\t{' '.join(q_words)}\n")
                judged = rng.choice(by_sub[s],
                                    size=min(judged_per_query, len(by_sub[s])),
                                    replace=False)
                for d in judged:
                    rf.write(f"{qid} 0 d{d} 1\n")
    print(f"synthetic workspace at {out_dir}: {n_docs} docs, {n_sub} "
          f"subtopics, vocab {len(vocab)}")


# -- the held-out split's data steps ---------------------------------------------

_SUB = re.compile(r"^sub(\d+)[a-z]$")


def complete_qrels(data_dir: str, splits: str = "train") -> None:
    """recipes/synthetic/complete_qrels.py: rewrite qrels.<split>.tsv in
    place with every doc of each query's subtopic judged relevant (the
    original kept as qrels.<split>.sparse.tsv)."""
    # subtopic words are "sub<digits><variant letter>"; the digit run grows
    # past 4 chars for >=10k subtopics, so key on the full numeric id
    sub_key = re.compile(r"sub\d+")
    by_sub = defaultdict(list)
    with open(os.path.join(data_dir, "corpus.tsv")) as f:
        for line in f:
            docid, title, _ = line.split("\t", 2)
            by_sub[sub_key.match(title.split(" ", 1)[0]).group(0)].append(docid)
    for split in splits.split(","):
        qrel_path = os.path.join(data_dir, f"qrels.{split}.tsv")
        sparse_path = os.path.join(data_dir, f"qrels.{split}.sparse.tsv")
        if not os.path.exists(sparse_path):
            shutil.copy(qrel_path, sparse_path)
        n_q, n_lines = 0, 0
        with open(os.path.join(data_dir, f"queries.{split}.tsv")) as fq, \
                open(qrel_path, "w") as fo:
            for line in fq:
                qid, text = line.rstrip("\n").split("\t", 1)
                sub_word = text.split(" ", 1)[0]
                assert sub_word.startswith("sub"), (qid, text)
                docs = by_sub[sub_key.match(sub_word).group(0)]
                for d in docs:
                    fo.write(f"{qid} 0 {d} 1\n")
                n_q += 1
                n_lines += len(docs)
        print(f"complete {split} qrels: {n_q} queries, {n_lines} judgments "
              f"(sparse original at {sparse_path})")


def _side(query_text: str) -> int:
    """0 (stage 0) or 1 (task) by a hash of the query's subtopic id, read
    from its first word, so that a subtopic's queries land on one side."""
    first = query_text.split()[0]
    m = _SUB.match(first)
    key = m.group(1) if m else first
    return hashlib.sha1(key.encode()).digest()[0] % 2


def split_heldout(src: str, out_root: str) -> None:
    """recipes/synthetic/split_queries_heldout.py: out_root/data_stage0 and
    out_root/data_task, each a DATA_DIR with half of src's subtopics'
    queries and qrels and a symlink to src's corpus.tsv."""
    dirs = [os.path.join(out_root, "data_stage0"),
            os.path.join(out_root, "data_task")]
    for d in dirs:
        os.makedirs(d, exist_ok=True)
        link = os.path.join(d, "corpus.tsv")
        if not os.path.exists(link):
            os.symlink(os.path.abspath(os.path.join(src, "corpus.tsv")), link)
    for split_name in ("train", "dev.small"):
        sides = {}
        outs = [open(os.path.join(d, f"queries.{split_name}.tsv"), "w")
                for d in dirs]
        with open(os.path.join(src, f"queries.{split_name}.tsv")) as f:
            for line in f:
                qid, text = line.rstrip("\n").split("\t")
                s = _side(text)
                sides[qid] = s
                outs[s].write(line)
        for o in outs:
            o.close()
        routs = [open(os.path.join(d, f"qrels.{split_name}.tsv"), "w")
                 for d in dirs]
        with open(os.path.join(src, f"qrels.{split_name}.tsv")) as f:
            for line in f:
                qid = line.split()[0]
                if qid in sides:
                    routs[sides[qid]].write(line)
        for o in routs:
            o.close()
        n0, n1 = (sum(1 for _ in open(os.path.join(d, f"queries.{split_name}.tsv")))
                  for d in dirs)
        print(f"{split_name}: stage0={n0} task={n1}")
        assert n0 and n1, "degenerate split — check the first-token hashing"


# -- BEIR layout -----------------------------------------------------------------

def beir_layout(data_dir: str, split: str, out_dir: str,
                sep_token: str = "[SEP]") -> None:
    """corpus.jsonl, queries.jsonl and qrels/test.tsv of one split of a
    DATA_DIR. A doc's text is its fields joined by `sep_token`, as
    eval/run_io.py::load_corpus joins them, under an empty title
    (load_beir_corpus then reads the same string); docs in corpus.tsv's
    order, queries in the split's order."""
    os.makedirs(os.path.join(out_dir, "qrels"), exist_ok=True)
    with open(os.path.join(data_dir, "corpus.tsv")) as f, \
            open(os.path.join(out_dir, "corpus.jsonl"), "w") as out:
        for line in f:
            docid, *fields = line.strip().split("\t")
            text = sep_token.join(t.strip() for t in fields)
            out.write(json.dumps({"_id": docid, "title": "", "text": text})
                      + "\n")
    with open(os.path.join(data_dir, f"queries.{split}.tsv")) as f, \
            open(os.path.join(out_dir, "queries.jsonl"), "w") as out:
        for line in f:
            qid, text = line.split("\t")
            out.write(json.dumps({"_id": qid, "text": text.strip()}) + "\n")
    with open(os.path.join(data_dir, f"qrels.{split}.tsv")) as f, \
            open(os.path.join(out_dir, "qrels", "test.tsv"), "w") as out:
        out.write("query-id\tcorpus-id\tscore\n")
        for line in f:
            qid, _, docid, rel = line.split()
            out.write(f"{qid}\t{docid}\t{rel}\n")
    print(f"BEIR layout of {data_dir} ({split}) at {out_dir}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="mode", required=True)
    toy = sub.add_parser("toy", help="recipes/toy/make_toy_data.py's workspace")
    toy.add_argument("--out_dir", default="./toy_workspace")
    toy.add_argument("--n_docs", type=int, default=2000)
    toy.add_argument("--n_queries", type=int, default=200)
    synth = sub.add_parser("synth", help="recipes/synthetic/make_synth_data.py's "
                                         "workspace")
    synth.add_argument("--out_dir", default="./synth_workspace")
    synth.add_argument("--n_docs", type=int, default=200_000)
    synth.add_argument("--n_train_queries", type=int, default=4000)
    synth.add_argument("--n_dev_queries", type=int, default=500)
    synth.add_argument("--n_topics", type=int, default=100)
    synth.add_argument("--subtopics_per_topic", type=int, default=20)
    synth.add_argument("--judged_per_query", type=int, default=4)
    synth.add_argument("--hidden_layers", type=int, default=12)
    synth.add_argument("--hidden_size", type=int, default=768)
    synth.add_argument("--seed", type=int, default=0)
    complete = sub.add_parser("complete-qrels",
                              help="recipes/synthetic/complete_qrels.py")
    complete.add_argument("--data_dir", required=True)
    complete.add_argument("--splits", default="train")
    heldout = sub.add_parser("split-heldout",
                             help="recipes/synthetic/split_queries_heldout.py")
    heldout.add_argument("src")
    heldout.add_argument("out_root")
    beir = sub.add_parser("beir", help="one split in the BEIR layout")
    beir.add_argument("--data_dir", required=True)
    beir.add_argument("--split", default="dev.small")
    beir.add_argument("--out_dir", required=True)
    beir.add_argument("--sep_token", default="[SEP]")
    args = vars(parser.parse_args(argv))
    mode = args.pop("mode")
    {"toy": make_toy, "synth": make_synth, "complete-qrels": complete_qrels,
     "split-heldout": split_heldout, "beir": beir_layout}[mode](**args)


if __name__ == "__main__":
    main()
