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

The port's own copy of repconc_tpu/eval/trec.py. Where the JAX package
sends a large run file to its C++ backend (repconc_tpu/native/
trec_eval.cpp), the port sends it to `evaluate_files`, a vectorised numpy
evaluator with that backend's semantics and result: same dispatch rule,
same values, an empty "perquery".
"""
from __future__ import annotations

import math
import os
import re
from collections import defaultdict
from typing import Dict, Mapping, Tuple, Union

import numpy as np

QrelsT = Mapping[str, Mapping[str, int]]
RunT = Mapping[str, Mapping[str, float]]

# file-path evaluate_run calls above this run.tsv size take evaluate_files
_NATIVE_MIN_RUN_BYTES = 50 * 1024 * 1024

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

    File-path inputs whose run is above _NATIVE_MIN_RUN_BYTES go to
    `evaluate_files`, as the JAX package sends them to its C++ backend; the
    result then carries "num_queries" and an empty "perquery". The JAX
    package evaluates them in Python, perquery kept, when it finds no
    compiler; `evaluate_files` needs none, so here that case does not
    arise.
    """
    if isinstance(qrel, str) and isinstance(run, str):
        try:
            big = os.path.getsize(run) > _NATIVE_MIN_RUN_BYTES
        except OSError:
            big = False
        if big:
            m = evaluate_files(qrel, run, tuple(k_values), tuple(mrr_k_values),
                               relevance_level)
            m["perquery"] = {}
            return m
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


# ---------------------------------------------------------------------------
# Large run files: the semantics of repconc_tpu/native/trec_eval.cpp
# ---------------------------------------------------------------------------

_LEADING_INT = re.compile(r"[+-]?\d+")
_LEADING_FLOAT = re.compile(
    r"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf(?:inity)?|nan)",
    re.IGNORECASE)


def _scan_int(tok: str):
    """sscanf's %ld: the leading decimal integer of `tok`, else None."""
    m = _LEADING_INT.match(tok)
    return int(m.group()) if m else None


def _scan_float(tok: str):
    """sscanf's %lf on a decimal token: its leading number, else None."""
    try:
        return float(tok)
    except ValueError:
        m = _LEADING_FLOAT.match(tok)
        return float(m.group()) if m else None


def _read_qrels_columns(path: str):
    """(qids, docids, rels) of the lines `qid iter docid rel`; a line
    without four fields or an integer rel is skipped, never cuts the file."""
    qids, docids, rels = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            rel = _scan_int(parts[3])
            if rel is None:
                continue
            qids.append(parts[0])
            docids.append(parts[2])
            rels.append(rel)
    return qids, docids, np.array(rels, dtype=np.int64)


def _read_run_columns(path: str):
    """(qids, docids, scores) of the lines `qid Q0 docid rank score ...`; a
    line without an integer rank and a numeric score is skipped."""
    qids, docids, scores = [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 5 or _scan_int(parts[3]) is None:
                continue
            score = _scan_float(parts[4])
            if score is None:
                continue
            qids.append(parts[0])
            docids.append(parts[2])
            scores.append(score)
    return qids, docids, np.array(scores, dtype=np.float64)


def _last_of_each(keys: np.ndarray) -> np.ndarray:
    """Indices of the last occurrence of each distinct key, in key order
    (a repeated line keeps its last value, as a dict does)."""
    _, first_rev = np.unique(keys[::-1], return_index=True)
    return len(keys) - 1 - first_rev


def _round5(v: float) -> float:
    """std::round(v * 1e5) / 1e5 for v >= 0 (halves away from zero)."""
    x = v * 100000.0
    r = math.floor(x)
    return (r + (1 if x - r >= 0.5 else 0)) / 100000.0


def _group_starts(sorted_groups: np.ndarray) -> np.ndarray:
    """Index of the first row of each row's group (rows sorted by group)."""
    n = len(sorted_groups)
    first = np.ones(n, dtype=bool)
    first[1:] = sorted_groups[1:] != sorted_groups[:-1]
    return np.maximum.accumulate(np.where(first, np.arange(n), 0))


def evaluate_files(qrel_path: str, run_path: str,
                   k_values: Tuple[int, ...] = (1, 3, 5, 10, 100),
                   mrr_k_values: Tuple[int, ...] = (10, 100),
                   relevance_level: int = 1) -> Dict[str, object]:
    """Metrics of a qrels file and a run file, vectorised over all lines.

    The semantics of trec_eval.cpp's header: rank by score DESC, docid
    string DESC; average over the queries in both the run and the qrels;
    graded NDCG gains; MAP divided by all relevant docs; MRR@k of the
    top-k; a repeated (qid, docid) keeps its last line; a malformed line
    is skipped. Returns the five metric groups, rounded to 5 decimals as
    the C++ backend rounds, and "num_queries" (no "perquery").
    """
    k_values, mrr_k_values = tuple(k_values), tuple(mrr_k_values)
    qq, qd, rel = _read_qrels_columns(qrel_path)
    rq, rd, score = _read_run_columns(run_path)
    qnames = np.unique(np.array(qq + rq, dtype=str))
    dnames = np.unique(np.array(qd + rd, dtype=str))  # id order = string order
    nd = max(len(dnames), 1)

    def keys(qs, ds):
        q = np.searchsorted(qnames, np.array(qs, dtype=str)).astype(np.int64)
        d = np.searchsorted(dnames, np.array(ds, dtype=str)).astype(np.int64)
        return q * nd + d

    qrel_key = keys(qq, qd)
    keep = _last_of_each(qrel_key)
    qrel_key, rel = qrel_key[keep], rel[keep]
    run_key = keys(rq, rd)
    keep = _last_of_each(run_key)
    run_key, score = run_key[keep], score[keep]

    evaluated = np.intersect1d(np.unique(qrel_key // nd), np.unique(run_key // nd))
    nq = len(evaluated)
    groups = {"ndcg": ("NDCG", k_values), "map": ("MAP", k_values),
              "recall": ("Recall", k_values), "precision": ("P", k_values),
              "mrr": ("MRR", mrr_k_values)}
    sums = {g: np.zeros(len(cuts)) for g, (_, cuts) in groups.items()}
    if nq:
        # the run's lines of evaluated queries, ranked within each query
        on = np.isin(run_key // nd, evaluated)
        run_key, score = run_key[on], score[on]
        q_run = np.searchsorted(evaluated, run_key // nd)
        order = np.lexsort((-(run_key % nd), -score, q_run))
        run_key, q_run = run_key[order], q_run[order]
        idx = np.arange(len(run_key))
        rank = idx - _group_starts(q_run) + 1
        pos = np.minimum(np.searchsorted(qrel_key, run_key), len(qrel_key) - 1)
        line_rel = np.where(qrel_key[pos] == run_key, rel[pos], 0)
        is_rel = line_rel >= relevance_level
        cum = np.cumsum(is_rel)
        hits_at = cum - np.where(_group_starts(q_run) > 0,
                                 cum[_group_starts(q_run) - 1], 0)
        gain = np.where(line_rel > 0, line_rel / np.log2(rank + 1.0), 0.0)
        prec_at_hit = np.where(is_rel, hits_at / rank, 0.0)

        # each evaluated query's qrels: relevant count and ideal gains
        on = np.isin(qrel_key // nd, evaluated)
        q_rel = np.searchsorted(evaluated, qrel_key[on] // nd)
        r = rel[on]
        num_rel = np.bincount(q_rel, weights=r >= relevance_level,
                              minlength=nq)
        pos_g = r > 0
        q_g, g = q_rel[pos_g], r[pos_g]
        order = np.lexsort((-g, q_g))
        q_g, g = q_g[order], g[order]
        ideal_rank = np.arange(len(g)) - _group_starts(q_g)
        ideal_gain = g / np.log2(ideal_rank + 2.0)

        def per_query(weights):
            return np.bincount(q_run, weights=weights, minlength=nq)

        with np.errstate(divide="ignore", invalid="ignore"):
            for j, k in enumerate(k_values):
                in_k = rank <= k
                hits = per_query(is_rel & in_k)
                dcg = per_query(np.where(in_k, gain, 0.0))
                ap = per_query(np.where(in_k, prec_at_hit, 0.0))
                idcg = np.bincount(q_g, weights=np.where(ideal_rank < k,
                                                         ideal_gain, 0.0),
                                   minlength=nq)
                sums["ndcg"][j] = np.where(idcg > 0, dcg / idcg, 0.0).sum()
                sums["map"][j] = np.where(num_rel > 0, ap / num_rel, 0.0).sum()
                sums["recall"][j] = np.where(num_rel > 0, hits / num_rel,
                                             0.0).sum()
                sums["precision"][j] = (hits / k).sum()
            first = np.full(nq, np.inf)
            np.minimum.at(first, q_run[is_rel], rank[is_rel].astype(np.float64))
            for j, cut in enumerate(mrr_k_values):
                sums["mrr"][j] = np.where(first <= cut, 1.0 / first, 0.0).sum()
    out: Dict[str, object] = {}
    for g, (prefix, cuts) in groups.items():
        out[g] = {f"{prefix}@{c}": (_round5(float(v) / nq) if nq else 0.0)
                  for c, v in zip(cuts, sums[g])}
    out["num_queries"] = nq
    return out
