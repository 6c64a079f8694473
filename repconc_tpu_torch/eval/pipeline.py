"""End-to-end evaluation pipeline: encode -> ADC or flat search -> TREC
metrics (counterpart of repconc_tpu/eval/pipeline.py:21-118)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from repconc_tpu_torch.core.profiling import Stopwatch
from repconc_tpu_torch.eval.encode import encode_corpus, encode_queries
from repconc_tpu_torch.eval.trec import evaluate_run
from repconc_tpu_torch.index.adc import batch_adc_search
from repconc_tpu_torch.index.flat import batch_flat_search


def run_from_topk(query_ids, all_scores, all_ids) -> Dict[str, Dict[str, float]]:
    """Non-finite scores are -inf pad sentinels — dropped, never ranked."""
    return {str(q): {str(d): float(s) for d, s in zip(dids, scs)
                     if np.isfinite(s)}
            for q, dids, scs in zip(query_ids, all_ids, all_scores)}


def repconc_retrieval(model, tokenizer, corpus: Dict[Any, str],
                      queries: Dict[Any, str], max_seq_length: int = 512,
                      topk: int = 1000, encode_batch: int = 256,
                      search_batch: int = 1200,
                      codes: Optional[np.ndarray] = None,
                      corpus_ids: Optional[np.ndarray] = None,
                      device="cuda", stopwatch: Stopwatch = None
                      ) -> Tuple[Dict, np.ndarray, np.ndarray, np.ndarray]:
    """Quantized retrieval: corpus to codes (argmin), queries to fp32
    embeddings, ADC search with the model's centroids. Returns (run, codes,
    corpus_ids, query_ids). `stopwatch` collects the phases encode_corpus,
    encode_queries and search, and inside the encodes tokenize and
    device_encode."""
    sw = stopwatch if stopwatch is not None else Stopwatch()
    if codes is None or corpus_ids is None:
        with sw("encode_corpus"):
            codes, corpus_ids = encode_corpus(
                corpus, model, tokenizer, max_seq_length,
                batch_size=encode_batch, output="code", device=device,
                stopwatch=sw)
    with sw("encode_queries"):
        q_embeds, query_ids = encode_queries(
            queries, model, tokenizer, max_seq_length,
            batch_size=encode_batch, device=device, stopwatch=sw)
    with sw("search"):
        scores, ids = batch_adc_search(
            query_ids, q_embeds, corpus_ids, codes,
            model.centroids.detach().cpu().numpy(), topk=topk,
            batch_size=search_batch, device=device)
    return run_from_topk(query_ids, scores, ids), codes, corpus_ids, query_ids


def evaluate_dense_model(model, tokenizer, corpus: Dict[Any, str],
                         queries: Dict[Any, str],
                         qrels: Dict[str, Dict[str, int]],
                         max_seq_length: int = 512, topk: int = 10,
                         encode_batch: int = 256, k_values=(10,),
                         mrr_k_values=(10,), device="cuda",
                         stopwatch: Stopwatch = None) -> Dict[str, float]:
    """Uncompressed validation (pipeline.py:58-86): corpus and queries to
    fp32 embeddings, exact flat inner-product search, TREC metrics. Stage 0
    validates with it, where a quantized eval would rank with untrained
    centroids."""
    sw = stopwatch if stopwatch is not None else Stopwatch()
    with sw("encode_corpus"):
        c_embeds, corpus_ids = encode_corpus(
            corpus, model, tokenizer, max_seq_length, batch_size=encode_batch,
            output="continuous_embedding", device=device, stopwatch=sw)
    with sw("encode_queries"):
        q_embeds, query_ids = encode_queries(
            queries, model, tokenizer, max_seq_length,
            batch_size=encode_batch, device=device, stopwatch=sw)
    with sw("search"):
        scores, ids = batch_flat_search(query_ids, q_embeds, corpus_ids,
                                        c_embeds, topk=topk, device=device)
    return flat_metrics(qrels, run_from_topk(query_ids, scores, ids),
                        k_values, mrr_k_values)


def flat_metrics(qrels, run, k_values, mrr_k_values) -> Dict[str, float]:
    """Flat {"MRR@10": ...} dict for validation logs."""
    metrics = evaluate_run(qrels, run, k_values=k_values,
                           mrr_k_values=mrr_k_values)
    flat: Dict[str, float] = {}
    for cat, d in metrics.items():
        if cat != "perquery":
            flat.update(d)
    return flat


def evaluate_repconc_model(model, tokenizer, corpus: Dict[Any, str],
                           queries: Dict[Any, str],
                           qrels: Dict[str, Dict[str, int]],
                           max_seq_length: int = 512, topk: int = 10,
                           encode_batch: int = 256, k_values=(10,),
                           mrr_k_values=(10,), device="cuda",
                           stopwatch: Stopwatch = None) -> Dict[str, float]:
    """Validation metric dict with a flat key space ({"MRR@10": ...})."""
    run, *_ = repconc_retrieval(
        model, tokenizer, corpus, queries, max_seq_length=max_seq_length,
        topk=topk, encode_batch=encode_batch, device=device,
        stopwatch=stopwatch)
    return flat_metrics(qrels, run, k_values, mrr_k_values)
