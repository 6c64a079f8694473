"""trec_eval-parity retrieval metrics, self-contained (numpy + stdlib).

Replaces the reference's native pytrec_eval / trec_eval C dependency
(reference: src/repconc/utils/eval_utils.py:144-201) with an exact-semantics
reimplementation:

* Documents are ranked by (score DESC, docid DESC-lexicographic) — trec_eval's
  tie-breaking rule (greater docno string wins ties).
* Only queries present in BOTH the run and the qrels are evaluated; averages
  divide by the number of evaluated queries.
* `ndcg_cut_k`: graded gains (raw rel), discount 1/log2(rank+1); ideal ranking
  sorted by rel DESC. Negative rels contribute 0 gain.
* `map_cut_k`: sum of precision@hit over relevant docs in top-k, divided by
  the TOTAL number of relevant docs R (not min(R, k)).
* `recall_k`, `P_k`, `recip_rank` standard.
* "relevant" for binary metrics means rel >= relevance_level (default 1).
* MRR@k computed by truncating each ranking to its top-k (by the same sort)
  and taking the reciprocal rank of the first relevant doc, matching the
  reference's `truncate_run` + recip_rank composition (eval_utils.py:136-141).

The port's own copy of repconc_tpu/eval/trec.py. The JAX package's C++
backend for large run files (repconc_tpu/native) is not carried over: every
input is evaluated here in Python.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Mapping, Tuple, Union

QrelsT = Mapping[str, Mapping[str, int]]
RunT = Mapping[str, Mapping[str, float]]

def parse_qrels(path: str) -> Dict[str, Dict[str, int]]:
    """Parse a TREC qrels file: `qid  iter  docid  rel` (whitespace-separated)."""
    qrels: Dict[str, Dict[str, int]] = defaultdict(dict)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            qid, _, docid, rel = parts[0], parts[1], parts[2], parts[3]
            qrels[qid][docid] = int(rel)
    return dict(qrels)


def parse_run(path: str) -> Dict[str, Dict[str, float]]:
    """Parse a TREC run file: `qid Q0 docid rank score name`."""
    run: Dict[str, Dict[str, float]] = defaultdict(dict)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            qid, docid, score = parts[0], parts[2], parts[4]
            run[qid][docid] = float(score)
    return dict(run)


def _ranked_docids(doc_scores: Mapping[str, float]) -> list:
    """Rank docids by trec_eval semantics: score DESC, docid string DESC."""
    # sort is stable; sort by docid desc first then score desc gives the
    # composite (score DESC, docid DESC) order.
    docs = sorted(doc_scores.keys(), reverse=True)
    docs.sort(key=lambda d: doc_scores[d], reverse=True)
    return docs


def truncate_run(run: RunT, topk: int) -> Dict[str, Dict[str, float]]:
    """Keep only each query's top-`topk` docs (trec_eval sort order).

    Mirrors reference eval_utils.py:136-141 (which used python sort by score
    only; we use the full trec_eval order so MRR@k is self-consistent).
    """
    new_run = {}
    for qid, doc_scores in run.items():
        ranked = _ranked_docids(doc_scores)[:topk]
        new_run[qid] = {d: doc_scores[d] for d in ranked}
    return new_run


def _evaluate_query(
    ranked: list,
    rels: Mapping[str, int],
    k_values: Tuple[int, ...],
    relevance_level: int,
) -> Dict[str, float]:
    """Compute cut metrics for one query given its ranked docids and qrels."""
    num_rel = sum(1 for r in rels.values() if r >= relevance_level)
    # gains for ndcg: raw graded relevance, floored at 0
    ideal_gains = sorted((max(r, 0) for r in rels.values()), reverse=True)

    out: Dict[str, float] = {}
    max_k = max(k_values)
    dcg = 0.0
    hits = 0
    ap_sum = 0.0
    ks = set(k_values)
    for i, docid in enumerate(ranked[:max_k]):
        rank = i + 1
        rel = rels.get(docid, 0)
        if rel > 0:
            dcg += rel / math.log2(rank + 1)
        if rel >= relevance_level:
            hits += 1
            ap_sum += hits / rank
        if rank in ks:
            _record_cut(out, rank, dcg, hits, ap_sum, num_rel, ideal_gains)
    # pad: if the ranking is shorter than some cutoffs, metrics at those
    # cutoffs equal the end-of-ranking values
    n = len(ranked)
    for k in k_values:
        if k > n and f"P_{k}" not in out:
            _record_cut(out, k, dcg, hits, ap_sum, num_rel, ideal_gains)

    # reciprocal rank over the full ranking
    rr = 0.0
    for i, docid in enumerate(ranked):
        if rels.get(docid, 0) >= relevance_level:
            rr = 1.0 / (i + 1)
            break
    out["recip_rank"] = rr
    return out


def _record_cut(out, k, dcg, hits, ap_sum, num_rel, ideal_gains):
    idcg = 0.0
    for i, g in enumerate(ideal_gains[:k]):
        if g <= 0:
            break
        idcg += g / math.log2(i + 2)
    out[f"ndcg_cut_{k}"] = (dcg / idcg) if idcg > 0 else 0.0
    out[f"map_cut_{k}"] = (ap_sum / num_rel) if num_rel > 0 else 0.0
    out[f"recall_{k}"] = (hits / num_rel) if num_rel > 0 else 0.0
    out[f"P_{k}"] = hits / k


def evaluate_run(
    qrel: Union[str, QrelsT],
    run: Union[str, RunT],
    k_values: Tuple[int, ...] = (1, 3, 5, 10, 100),
    mrr_k_values: Tuple[int, ...] = (10, 100),
    relevance_level: int = 1,
) -> Dict[str, Dict]:
    """Full retrieval evaluation with the reference's output schema.

    Returns {"ndcg": {"NDCG@k": v}, "map": {"MAP@k": v}, "recall": ...,
    "precision": ..., "mrr": {"MRR@k": v}, "perquery": {qid: {...}}},
    values rounded to 5 decimals, averaged over evaluated queries
    (reference: eval_utils.py:144-201).
    """
    if isinstance(qrel, str):
        qrel = parse_qrels(qrel)
    if isinstance(run, str):
        run = parse_run(run)
    # normalize ids to str so int-keyed runs (from np arrays) work
    qrel = {str(q): {str(d): int(r) for d, r in ds.items()} for q, ds in qrel.items()}
    run = {str(q): {str(d): float(s) for d, s in ds.items()} for q, ds in run.items()}

    ndcg: Dict[str, float] = {f"NDCG@{k}": 0.0 for k in k_values}
    map_: Dict[str, float] = {f"MAP@{k}": 0.0 for k in k_values}
    recall: Dict[str, float] = {f"Recall@{k}": 0.0 for k in k_values}
    precision: Dict[str, float] = {f"P@{k}": 0.0 for k in k_values}
    mrr: Dict[str, float] = {f"MRR@{k}": 0.0 for k in mrr_k_values}

    perquery: Dict[str, Dict[str, float]] = {}
    for qid, doc_scores in run.items():
        rels = qrel.get(qid)
        if not rels:
            continue
        ranked = _ranked_docids(doc_scores)
        q_scores = _evaluate_query(ranked, rels, tuple(k_values), relevance_level)
        for cut in mrr_k_values:
            rr = 0.0
            for i, docid in enumerate(ranked[:cut]):
                if rels.get(docid, 0) >= relevance_level:
                    rr = 1.0 / (i + 1)
                    break
            q_scores[f"recip_rank_{cut}"] = rr
        perquery[qid] = q_scores

    n = len(perquery)
    if n > 0:
        for q_scores in perquery.values():
            for k in k_values:
                ndcg[f"NDCG@{k}"] += q_scores[f"ndcg_cut_{k}"]
                map_[f"MAP@{k}"] += q_scores[f"map_cut_{k}"]
                recall[f"Recall@{k}"] += q_scores[f"recall_{k}"]
                precision[f"P@{k}"] += q_scores[f"P_{k}"]
            for cut in mrr_k_values:
                mrr[f"MRR@{cut}"] += q_scores[f"recip_rank_{cut}"]
        for d in (ndcg, map_, recall, precision, mrr):
            for key in d:
                d[key] = round(d[key] / n, 5)

    return {
        "ndcg": ndcg,
        "map": map_,
        "recall": recall,
        "precision": precision,
        "mrr": mrr,
        "perquery": perquery,
    }
