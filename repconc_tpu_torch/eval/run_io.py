"""Corpus/query/qrels loading and TREC run writing.

The port's own copy of repconc_tpu/eval/run_io.py: host-side data
plumbing, matching the reference's file formats
(src/repconc/utils/eval_utils.py:46-133 and run writers in
src/repconc/evaluate/run_*.py):

* MS MARCO TSV corpus: `docid \\t field1 \\t field2...` — fields joined with
  the tokenizer's sep token, truncated to 10k chars.
* MS MARCO TSV queries: `qid \\t text`.
* BEIR jsonl corpus: {"_id", "title", "text"} — title + body concatenation.
* BEIR TSV qrels with a header row.
* TREC run format: `qid Q0 docid rank score name`.
"""
from __future__ import annotations

import csv
import json
from typing import Dict, Iterable

import numpy as np

MAX_DOC_CHARS = 10_000


def concat_title_body(doc: Dict[str, str]) -> str:
    """BEIR title+body joining with sentence-final punctuation handling
    (reference: eval_utils.py:33-43)."""
    body = doc["text"].strip()
    title = doc.get("title", "").strip()
    if title:
        if title[-1] in "!.?。！？":
            return title + " " + body
        return title + ". " + body
    return body


def load_corpus(corpus_path: str, sep_token: str) -> Dict[str, str]:
    corpus: Dict[str, str] = {}
    with open(corpus_path) as f:
        for line in f:
            splits = line.strip().split("\t")
            corpus_id, text_fields = splits[0], splits[1:]
            text = f"{sep_token}".join(t.strip() for t in text_fields)
            corpus[corpus_id] = text[:MAX_DOC_CHARS]
    return corpus


def load_queries(query_path: str) -> Dict[str, str]:
    queries: Dict[str, str] = {}
    with open(query_path) as f:
        for line in f:
            qid, text = line.split("\t")
            queries[qid] = text.strip()
    return queries


def load_beir_corpus(corpus_path: str) -> Dict[str, str]:
    corpus: Dict[str, str] = {}
    with open(corpus_path) as f:
        for line in f:
            data = json.loads(line)
            corpus[data["_id"]] = concat_title_body(data)[:MAX_DOC_CHARS]
    return corpus


def load_beir_queries(query_path: str) -> Dict[str, str]:
    queries: Dict[str, str] = {}
    with open(query_path) as f:
        for line in f:
            data = json.loads(line)
            queries[data["_id"]] = data["text"].strip()
    return queries


def load_beir_qrels(qrel_path: str) -> Dict[str, Dict[str, int]]:
    with open(qrel_path, encoding="utf-8") as f:
        reader = csv.reader(f, delimiter="\t", quoting=csv.QUOTE_MINIMAL)
        next(reader)  # header
        qrels: Dict[str, Dict[str, int]] = {}
        for row in reader:
            query_id, corpus_id, score = row[0], row[1], int(row[2])
            qrels.setdefault(query_id, {})[corpus_id] = score
    return qrels


def load_qrels(qrel_path: str, rel_threshold: int = 1) -> Dict[str, list]:
    """TREC qrels -> {qid: [positive docids]} (training-style view,
    reference: finetune_repconc.py:160-166)."""
    qrels: Dict[str, list] = {}
    with open(qrel_path) as f:
        for line in f:
            qid, _, docid, rel = line.split()
            if int(rel) >= rel_threshold:
                qrels.setdefault(qid, []).append(docid)
    return qrels


def write_run_tsv(
    out_path: str,
    query_ids: Iterable,
    all_topk_scores: np.ndarray,
    all_topk_ids: np.ndarray,
    run_name: str = "System",
) -> None:
    """Write a TREC run file (reference: run_repconc_eval.py:101-105).

    Entries with non-finite scores are dropped: IVF search pads short
    candidate sets with score=-inf sentinels (ivf.py / pallas_ivf.py), which
    must not surface as ranked documents.
    """
    with open(out_path, "w") as output:
        for qid, topk_scores, topk_ids in zip(query_ids, all_topk_scores, all_topk_ids):
            rank = 0
            for score, docid in zip(topk_scores, topk_ids):
                if not np.isfinite(score):
                    continue
                rank += 1
                output.write(f"{qid}\tQ0\t{docid}\t{rank}\t{score}\t{run_name}\n")
