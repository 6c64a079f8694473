"""Training data pipeline: qrel-driven query/passage sampling + collation.

A copy of repconc_tpu/train/data.py (numpy only; the port imports nothing
of the JAX package), so that the same seed gives the same batches in both
packages. Host-side equivalent of the reference's QDRelDataset +
FinetuneCollator (finetune_repconc.py:62-213) with fixed shapes:

* queries/corpus loaded from TSV into RAM; qrels filtered by rel_threshold;
* per query: one random positive + `negative_per_query` negatives drawn from
  "random" (uniform corpus), a hard-negative JSON ({qid: [docid...]}) or
  "inbatch" (no explicit negatives);
* batches are a FIXED size (drop-last) and tokenized to FIXED max lengths as in
  the JAX package;
* each batch carries qids/docids plus a padded per-query positives matrix so
  the false-negative mask is computed on device (no per-step python loops
  over qrels, unlike the reference's finetune_repconc.py:433-440).
"""
from __future__ import annotations

import json
import logging
import random
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

MAX_DOC_CHARS = 10_000

_warned_truncated_positives = False


def padded_positives(samples: List[Dict[str, Any]],
                     qrels: Dict[int, List[int]],
                     max_positives: int) -> np.ndarray:
    """(B, max_positives) int32 matrix of judged-positive offsets, -1 padded.

    The sampled positive always occupies column 0 so the row covering the
    contrastive label can never be truncated away; remaining judged positives
    fill the rest. The reference masks ALL judged positives
    (finetune_repconc.py:433-440) — if a query has more than `max_positives`
    we warn once, since the overflow docs could then score as in-batch
    negatives (raise max_positives to the dataset's max qrels length to get
    exact reference semantics).
    """
    global _warned_truncated_positives
    P = max_positives
    positives = np.full((len(samples), P), -1, dtype=np.int32)
    truncated = 0
    for i, s in enumerate(samples):
        sampled = s["pos_docid"]
        row = [sampled] + [d for d in qrels.get(s["qid"], []) if d != sampled]
        if len(row) > P:
            truncated += 1
        row = row[:P]
        positives[i, :len(row)] = row
    if truncated and not _warned_truncated_positives:
        _warned_truncated_positives = True
        logger.warning(
            "%d queries in this batch have more than max_positives=%d judged "
            "positives; the overflow is not false-negative-masked. Raise "
            "max_positives to the dataset's max qrels length for exact "
            "reference mask semantics.", truncated, P)
    return positives


class QDRelDataset:
    """Queries + corpus + qrels with negative sampling."""

    def __init__(
        self,
        qrel_path: str,
        query_path: str,
        corpus_path: str,
        negative: str = "random",
        negative_per_query: int = 1,
        rel_threshold: int = 1,
        sep_token: str = "[SEP]",
        max_positives: int = 8,
    ):
        self.queries: List[str] = []
        qid2offset: Dict[str, int] = {}
        with open(query_path) as f:
            for idx, line in enumerate(f):
                qid, query = line.split("\t", 1)  # queries may embed tabs
                qid2offset[qid] = idx
                self.queries.append(query.strip())

        self.corpus: List[str] = []
        docid2offset: Dict[str, int] = {}
        with open(corpus_path) as f:
            for idx, line in enumerate(f):
                splits = line.strip().split("\t")
                docid, text_fields = splits[0], splits[1:]
                text = f"{sep_token}".join(t.strip() for t in text_fields)
                docid2offset[docid] = idx
                self.corpus.append(text.strip()[:MAX_DOC_CHARS])

        self.qrels: Dict[int, List[int]] = {}
        dropped = 0
        with open(qrel_path) as f:
            for line in f:
                qid, _, docid, rel = line.split()
                # a full qrels file against a subsampled corpus/query set is
                # routine (toy workspaces, BEIR slices): skip unjudgeable
                # lines instead of KeyError-ing dataset construction
                if qid not in qid2offset or docid not in docid2offset:
                    dropped += 1
                    continue
                if int(rel) >= rel_threshold:
                    self.qrels.setdefault(qid2offset[qid], []).append(
                        docid2offset[docid])
        if dropped:
            logger.warning("qrels: dropped %d lines whose qid/docid is not "
                           "in the query/corpus TSVs", dropped)

        self.negative_per_query = negative_per_query
        if negative not in ("inbatch", "random"):
            neg_map = {}
            for qid, docid_lst in json.load(open(negative)).items():
                if qid in qid2offset:
                    neg_map[qid2offset[qid]] = [
                        docid2offset[d] for d in docid_lst
                        if d in docid2offset]
            self.negative: Any = neg_map
        else:
            self.negative = negative

        self.qids = sorted(self.qrels.keys())
        self.max_positives = max_positives
        self.qid2offset = qid2offset
        self.docid2offset = docid2offset

    def __len__(self):
        return len(self.qids)

    def sample(self, qoffset: int, rng: random.Random) -> Dict[str, Any]:
        """One training example (reference: finetune_repconc.py:187-213)."""
        pos_docids = self.qrels[qoffset]
        pos_docid = rng.choice(pos_docids)
        data = {
            "qid": qoffset,
            "query": self.queries[qoffset],
            "pos_docid": pos_docid,
            "pos_doc": self.corpus[pos_docid],
        }
        if self.negative == "inbatch":
            assert self.negative_per_query == 0
            data["neg_docids"], data["neg_docs"] = [], []
        else:
            pool = (None if self.negative == "random"
                    else self.negative.get(qoffset))
            if pool is None:
                # random negatives; also the fallback for queries absent
                # from the hard-negative file
                neg_docids = rng.sample(range(len(self.corpus)),
                                        self.negative_per_query)
            elif len(pool) >= self.negative_per_query:
                neg_docids = rng.sample(pool, self.negative_per_query)
            else:  # degenerate pool: sample with replacement
                neg_docids = [rng.choice(pool)
                              for _ in range(self.negative_per_query)]
            data["neg_docids"] = neg_docids
            data["neg_docs"] = [self.corpus[d] for d in neg_docids]
        return data


class QueryDataset:
    """Stage-2 dataset: queries + qrels resolved to INDEX OFFSETS of a built
    code index (reference: finetune_jpq.py:86-139)."""

    def __init__(
        self,
        qrel_path: str,
        query_path: str,
        index_doc_ids: np.ndarray,
        rel_threshold: int = 1,
    ):
        docid2offset = {str(d): i for i, d in enumerate(index_doc_ids)}
        self.queries: List[str] = []
        qid2offset: Dict[str, int] = {}
        with open(query_path) as f:
            for idx, line in enumerate(f):
                qid, query = line.split("\t", 1)
                qid2offset[qid] = idx
                self.queries.append(query.strip())

        self.qrels: Dict[int, List[int]] = {}
        with open(qrel_path) as f:
            for line in f:
                qid, _, docid, rel = line.split()
                if qid not in qid2offset:
                    continue
                if int(rel) >= rel_threshold and docid in docid2offset:
                    self.qrels.setdefault(qid2offset[qid], []).append(
                        docid2offset[docid])
        self.qids = sorted(self.qrels.keys())

    def __len__(self):
        return len(self.qids)

    def sample(self, qoffset: int, rng: random.Random) -> Dict[str, Any]:
        return {
            "qid": qoffset,
            "query": self.queries[qoffset],
            "pos_docid": rng.choice(self.qrels[qoffset]),
        }


@dataclass
class QueryCollator:
    """Stage-2 batch: query tokens + sampled positive offsets + padded
    positives (reference: FinetuneQueryCollator, finetune_jpq.py:53-83)."""

    tokenizer: Any
    max_query_len: int
    max_positives: int = 8

    def __call__(self, samples: List[Dict[str, Any]],
                 qrels: Dict[int, List[int]]) -> Dict[str, np.ndarray]:
        from repconc_tpu_torch.eval.encode import accepts_text_type

        kwargs = ({"input_text_type": "query"}
                  if accepts_text_type(self.tokenizer) else {})
        out = self.tokenizer([s["query"] for s in samples], padding="max_length",
                             truncation=True, max_length=self.max_query_len,
                             **kwargs)
        positives = padded_positives(samples, qrels, self.max_positives)
        return {
            "query_input_ids": np.asarray(out["input_ids"], dtype=np.int32),
            "query_attention_mask": np.asarray(out["attention_mask"], dtype=np.int32),
            "qids": np.asarray([s["qid"] for s in samples], dtype=np.int32),
            "pos_docids": np.asarray([s["pos_docid"] for s in samples],
                                     dtype=np.int32),
            "query_positives": positives,
        }


@dataclass
class FinetuneCollator:
    """Tokenize a list of samples into one fixed-shape device batch."""

    tokenizer: Any
    max_query_len: int
    max_doc_len: int
    max_positives: int = 8

    def _tok(self, texts, max_len, text_type):
        from repconc_tpu_torch.eval.encode import accepts_text_type

        kwargs = ({"input_text_type": text_type}
                  if accepts_text_type(self.tokenizer) else {})
        out = self.tokenizer(texts, padding="max_length", truncation=True,
                             max_length=max_len, **kwargs)
        return (np.asarray(out["input_ids"], dtype=np.int32),
                np.asarray(out["attention_mask"], dtype=np.int32))

    def __call__(self, samples: List[Dict[str, Any]],
                 qrels: Dict[int, List[int]]) -> Dict[str, np.ndarray]:
        q_ids, q_mask = self._tok([s["query"] for s in samples],
                                  self.max_query_len, "query")
        pos_ids, pos_mask = self._tok([s["pos_doc"] for s in samples],
                                      self.max_doc_len, "doc")
        batch = {
            "query_input_ids": q_ids,
            "query_attention_mask": q_mask,
            "pos_input_ids": pos_ids,
            "pos_attention_mask": pos_mask,
            "qids": np.asarray([s["qid"] for s in samples], dtype=np.int32),
            "pos_docids": np.asarray([s["pos_docid"] for s in samples],
                                     dtype=np.int32),
        }
        neg_docs = sum((s["neg_docs"] for s in samples), [])
        if neg_docs:
            neg_ids, neg_mask = self._tok(neg_docs, self.max_doc_len, "doc")
            batch["neg_input_ids"] = neg_ids
            batch["neg_attention_mask"] = neg_mask
            batch["neg_docids"] = np.asarray(
                sum((s["neg_docids"] for s in samples), []), dtype=np.int32)
        # padded per-query positives for the device-side false-negative mask
        batch["query_positives"] = padded_positives(samples, qrels,
                                                    self.max_positives)
        return batch


def batch_iterator(
    dataset: QDRelDataset,
    collator: FinetuneCollator,
    batch_size: int,
    num_epochs: Optional[int] = None,
    seed: int = 2022,
    drop_last: bool = True,
) -> Iterator[Dict[str, np.ndarray]]:
    """Epoch-shuffled fixed-size batches (drop-last for static shapes)."""
    rng = random.Random(seed)
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = list(dataset.qids)
        rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            samples = [dataset.sample(q, rng)
                       for q in order[start:start + batch_size]]
            yield collator(samples, dataset.qrels)
        if not drop_last and len(order) % batch_size:
            tail = order[-(len(order) % batch_size):]
            samples = [dataset.sample(q, rng) for q in tail]
            yield collator(samples, dataset.qrels)
        epoch += 1
