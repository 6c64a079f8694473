#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (repconc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (flushed, with elapsed_s), so that a cut run
shows where it stopped:

  0 device      no GPU -> exit 1 at once; the card's name and power limit
  1 build       nvcc builds every kernel of the path (K1: csrc/adc_scan.cu)
  2 k1_check    K1 against its plain PyTorch version on the card, at M=12
                (Q x N grid), M=48, M=96 and the main path's shapes: scores
                to rtol=atol=1e-5, top-1000 ids equal except near-ties
                (< 1e-5 apart); kernel, plain and bound times
  3 full_scan   CudaADCIndex over 8,841,823 random M=12 codes (MS MARCO's
                passage count), one 1200-query top-1000 search
  4 main_path   repconc_retrieval at bert-base width (the M=12 checkpoint's
                config, seeded random weights) over 8192 synthetic docs and
                256 queries, on the card; launch counts read around it;
                ranking checked against the plain scorer, 8 docs checked
                against the CPU (proves TF32 is off), TREC run written and
                scored
  5 kernels     one JSON line per the port's kernel table

The last lines are the kernels line, the card's `nvidia-smi` name and power
limit, and {"ok": true, "device": {...}}. Any failure raises and exits
non-zero. The script writes only to a temporary directory and to the
package's _build/ directory. It imports torch, numpy, the standard library
and repconc_tpu_torch; nothing of JAX.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

T0 = time.perf_counter()
SEED = 2022
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores
ADC_TOL = 1e-5               # kernel vs plain: f32 sums in the same m order
MSMARCO_PASSAGES = 8_841_823


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase,
                      "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip()


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of `reps` CUDA-event timings after `warmup` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def adc_bound(Q: int, N: int, M: int, K: int):
    """Least time for the scan's work on an H100 SXM: codes, LUT and scores
    moved once over HBM, against Q*N*M f32 adds."""
    nbytes = N * M + Q * M * K * 2 + Q * N * 4
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = Q * N * M / H100_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def topk_agree(s_a, i_a, scores_b, k_tol: float) -> bool:
    """Top-k ids i_a (with scores s_a) against a full score matrix scores_b:
    equal except where neighbouring scores differ by less than k_tol."""
    import torch

    s_b, i_b = torch.topk(scores_b, i_a.shape[1], dim=1)
    diff = i_a != i_b
    if not bool(diff.any()):
        return True
    near = (torch.gather(scores_b, 1, i_a) - s_b).abs() < k_tol
    return bool(near[diff].all()) and bool(((s_a - s_b).abs() < k_tol).all())


def phase_k1_check(dev):
    import torch
    from repconc_tpu_torch.index.adc import score_codes_reference
    from repconc_tpu_torch.index.cuda_adc import adc_scores

    shapes = [(Q, N, 12) for Q in (1, 129, 1200)
              for N in (1, 1000, 100_003, 1_048_576)]
    shapes += [(129, 100_003, 48), (129, 100_003, 96),
               (256, 8192, 12),        # the main path's search (phase 4)
               (1200, 1 << 17, 12)]    # one chunk of the full scan (phase 3)
    K = 256
    results, worst = {}, 0.0
    for Q, N, M in shapes:
        g = torch.Generator(device=dev).manual_seed(SEED + Q * 31 + N + M)
        lut = torch.randn((Q, M, K), generator=g, device=dev).to(torch.bfloat16)
        codes = torch.randint(0, K, (N, M), generator=g, device=dev,
                              dtype=torch.uint8)
        got = adc_scores(lut, codes)
        want = score_codes_reference(lut, codes)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=ADC_TOL, atol=ADC_TOL)
        k = min(1000, N)
        s_got, i_got = torch.topk(got, k, dim=1)
        check(topk_agree(s_got, i_got, want, ADC_TOL),
              f"K1 top-{k} ids at Q={Q} N={N} M={M}")
        ms = time_ms(lambda: adc_scores(lut, codes))
        plain_ms = time_ms(lambda: score_codes_reference(lut, codes))
        bound_ms, bound_by = adc_bound(Q, N, M, K)
        worst = max(worst, err)
        results[(Q, N, M)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                  bound_by=bound_by, max_abs_err=err)
        emit("k1_check", Q=Q, N=N, M=M, K=K, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=None)
        del lut, codes, got, want, s_got, i_got
        torch.cuda.empty_cache()
    return results, worst


def phase_full_scan(dev):
    import torch
    from repconc_tpu_torch.index.cuda_adc import CudaADCIndex

    M, K, D, Q, topk = 12, 256, 768, 1200, 1000
    g = torch.Generator(device=dev).manual_seed(SEED)
    codes = torch.randint(0, K, (MSMARCO_PASSAGES, M), generator=g, device=dev,
                          dtype=torch.uint8)
    cent = torch.randn((M, K, D // M), generator=g, device=dev)
    queries = torch.randn((Q, D), generator=g, device=dev)
    index = CudaADCIndex(codes, cent, device=dev)
    del codes
    index.search_device(queries[:8], topk)  # first call: cuBLAS, attributes
    torch.cuda.synchronize()
    t = time.perf_counter()
    s, i = index.search_device(queries, topk)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t
    nc = index.codes.shape[0] // index.chunk
    check(tuple(s.shape) == (Q, topk) and bool(torch.isfinite(s).all()),
          "full scan: finite (Q, topk) scores")
    check(bool((i >= 0).all()) and bool((i < MSMARCO_PASSAGES).all()),
          "full scan: ids in range")
    check(bool((s[:, :-1] >= s[:, 1:]).all()), "full scan: sorted scores")
    # the returned scores are the plain sums of the returned docs' codes
    from repconc_tpu_torch.index.adc import build_lut

    lut = build_lut(queries, index.centroids).to(torch.bfloat16).float()
    picked = index.codes[i].long()                         # (Q, topk, M)
    resum = torch.zeros_like(s)
    for m in range(M):
        resum += lut[:, m].gather(1, picked[:, :, m])
    err = float((resum - s).abs().max())
    check(err <= ADC_TOL, f"full scan: returned scores re-summed ({err})")
    # one chunk's parts: the K1 scan and the per-chunk top-k
    from repconc_tpu_torch.index.cuda_adc import adc_scores

    lut_bf16 = lut.to(torch.bfloat16).contiguous()
    chunk_codes = index.codes[:index.chunk]
    scan_ms = time_ms(lambda: adc_scores(lut_bf16, chunk_codes))
    scores = adc_scores(lut_bf16, chunk_codes)
    topk_ms = time_ms(lambda: torch.topk(scores, topk, dim=1, sorted=False))
    emit("full_scan", N=MSMARCO_PASSAGES, M=M, K=K, Q=Q, topk=topk,
         chunks=nc, chunk=index.chunk, codes_mb=index.codes.numel() / 1e6,
         search_s=search_s, queries_per_s=Q / search_s,
         ms_per_chunk=search_s * 1e3 / nc, chunk_scan_ms=scan_ms,
         chunk_topk_ms=topk_ms, rescore_max_abs_err=err)
    del index, s, i, lut, picked, resum, lut_bf16, chunk_codes, scores
    torch.cuda.empty_cache()


class HashTokenizer:
    """Stand-in for a BERT tokenizer, so the smoke run needs no
    `transformers`: lower-cased whitespace words hashed into the vocab between
    [CLS] and [SEP], padded to the longest row, with the HF call
    convention."""

    pad_id, cls_id, sep_id, first_word_id = 0, 101, 102, 1000
    sep_token = "[SEP]"

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def _word(self, w: str) -> int:
        span = self.vocab_size - self.first_word_id
        return self.first_word_id + zlib.crc32(w.lower().encode()) % span

    def __call__(self, texts, padding=True, truncation=True, max_length=512):
        rows = []
        for t in texts:
            ids = [self._word(w) for w in t.split()]
            if truncation:
                ids = ids[:max_length - 2]
            rows.append([self.cls_id] + ids + [self.sep_id])
        width = max(len(r) for r in rows)
        return {"input_ids": [r + [self.pad_id] * (width - len(r)) for r in rows],
                "attention_mask": [[1] * len(r) + [0] * (width - len(r))
                                   for r in rows]}


def synthetic_data(n_docs: int = 8192, n_queries: int = 256):
    """Docs of 16-128 words from a Zipf-like vocabulary; each query is a
    prefix of one doc, which is its only judged-relevant doc."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    words = np.array([f"w{j}" for j in range(20_000)])
    p = 1.0 / np.arange(1, len(words) + 1)
    p /= p.sum()
    lengths = rng.integers(16, 129, size=n_docs)
    drawn = words[rng.choice(len(words), size=int(lengths.sum()), p=p)]
    ends = np.cumsum(lengths)
    corpus = {f"d{j}": " ".join(drawn[end - n:end])
              for j, (n, end) in enumerate(zip(lengths, ends))}
    targets = rng.choice(n_docs, size=n_queries, replace=False)
    queries, qrels = {}, {}
    for j, t in enumerate(targets):
        doc = corpus[f"d{t}"].split()
        queries[f"q{j}"] = " ".join(doc[:int(rng.integers(4, 13))])
        qrels[f"q{j}"] = {f"d{t}": 1}
    return corpus, queries, qrels


def phase_main_path(dev):
    import copy

    import numpy as np
    import torch
    from repconc_tpu_torch.core.config import EncoderConfig, RepConcConfig
    from repconc_tpu_torch.core.profiling import Stopwatch
    from repconc_tpu_torch.eval.encode import encode_queries, encode_texts
    from repconc_tpu_torch.eval.pipeline import repconc_retrieval
    from repconc_tpu_torch.eval.run_io import write_run_tsv
    from repconc_tpu_torch.eval.trec import evaluate_run
    from repconc_tpu_torch.index.adc import build_lut, score_codes_reference
    from repconc_tpu_torch.index.cuda_adc import adc_scores
    from repconc_tpu_torch.models.repconc_model import RepConcModel, init_random_

    # the config of the M=12 checkpoint (artifacts/r5h_m12_conc_best.tar)
    config = RepConcConfig(
        encoder=EncoderConfig(model_type="bert", vocab_size=7905,
                              hidden_size=768, num_hidden_layers=12,
                              num_attention_heads=12, intermediate_size=3072,
                              max_position_embeddings=512, type_vocab_size=2,
                              pooling="mean"),
        MCQ_M=12, MCQ_K=256, similarity_metric="METRIC_IP")
    cpu_model = init_random_(RepConcModel(config),
                             torch.Generator().manual_seed(SEED), std=0.02)
    model = copy.deepcopy(cpu_model).to(dev)
    tok = HashTokenizer(config.encoder.vocab_size)
    corpus, queries, qrels = synthetic_data()
    max_len, topk = 128, 1000
    emit("main_path_setup", docs=len(corpus), queries=len(queries),
         params=sum(p.numel() for p in model.parameters()))

    sw = Stopwatch()
    adc_scores.launches = 0
    run, codes, corpus_ids, query_ids = repconc_retrieval(
        model, tok, corpus, queries, max_seq_length=max_len, topk=topk,
        encode_batch=256, search_batch=1200, device=dev, stopwatch=sw)
    torch.cuda.synchronize()
    launches = {"adc_scan": adc_scores.launches}
    check(launches["adc_scan"] > 0, "main path launched K1")
    check(codes.shape == (len(corpus), 12) and codes.dtype == np.uint8,
          "corpus codes (N, M) uint8")
    check(len(run) == len(queries) and all(
        len(d) == min(topk, len(corpus)) and all(np.isfinite(v) for v in d.values())
        for d in run.values()), "run: topk finite scores per query")

    with tempfile.TemporaryDirectory() as tmp:
        ranked = [sorted(run[q].items(), key=lambda kv: -kv[1]) for q in query_ids]
        run_path = os.path.join(tmp, "run.tsv")
        qrel_path = os.path.join(tmp, "qrels.tsv")
        write_run_tsv(run_path, query_ids,
                      np.array([[s for _, s in r] for r in ranked]),
                      np.array([[d for d, _ in r] for r in ranked]))
        with open(qrel_path, "w") as f:
            f.writelines(f"{q} 0 {d} {r}\n" for q, ds in qrels.items()
                         for d, r in ds.items())
        metrics = evaluate_run(qrel_path, run_path, k_values=(10, 100, 1000),
                               mrr_k_values=(10,))
    mrr10 = metrics["mrr"]["MRR@10"]
    check(0.0 <= mrr10 <= 1.0, "MRR@10 in [0, 1]")

    # the same query embeddings and codes ranked by the plain scorer
    q_embeds, _ = encode_queries(queries, model, tok, max_len, device=dev)
    lut = build_lut(torch.as_tensor(q_embeds, device=dev),
                    model.centroids.detach()).to(torch.bfloat16)
    plain = score_codes_reference(lut, torch.as_tensor(codes, device=dev))
    row_of = {cid: j for j, cid in enumerate(corpus_ids)}
    got_i = torch.tensor([[row_of[d] for d, _ in r] for r in ranked], device=dev)
    got_s = torch.tensor([[s for _, s in r] for r in ranked], device=dev)
    check(topk_agree(got_s, got_i, plain, ADC_TOL),
          "main path top-k equals the plain scorer's except near-ties")

    # 8 docs on the CPU and on the card: agreement to 1e-4 shows TF32 is off
    texts = [corpus[c] for c in corpus_ids[:8]]
    on_cpu = encode_texts(texts, cpu_model, tok, max_len, device="cpu")
    on_card = encode_texts(texts, model, tok, max_len, device=dev)
    cpu_gap = float(np.abs(on_cpu - on_card).max())
    check(cpu_gap <= 1e-4, f"card vs CPU embeddings within 1e-4 ({cpu_gap})")

    t = sw.totals
    emit("main_path", launches=launches, encode_corpus_s=t["encode_corpus"],
         docs_per_s=len(corpus) / t["encode_corpus"],
         tokenize_s=t["tokenize"], device_encode_s=t["device_encode"],
         encode_queries_s=t["encode_queries"], search_s=t["search"],
         search_queries_per_s=len(queries) / t["search"], mrr_at_10=mrr10,
         recall_at_1000=metrics["recall"]["Recall@1000"],
         card_vs_cpu_max_abs_diff=cpu_gap,
         tf32=torch.backends.cuda.matmul.allow_tf32)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no GPU found (torch.cuda.is_available() is False)",
              file=sys.stderr, flush=True)
        return 1
    from repconc_tpu_torch import build
    from repconc_tpu_torch.core.device import resolve_device

    dev = resolve_device("cuda")
    card = card_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    b = build.build("adc_scan.cu")
    ptxas = [ln.strip() for ln in b.log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", kernel="adc_scan", seconds=b.seconds, library=b.path.name,
         ptxas=ptxas)

    k1, worst = phase_k1_check(dev)
    phase_full_scan(dev)
    launches = phase_main_path(dev)

    chunk = k1[(1200, 1 << 17, 12)]
    print(json.dumps({"kernels": [{
        "name": "adc_scan", "route": "cuda",
        "source": "repconc_tpu_torch/csrc/adc_scan.cu",
        "replaces": "repconc_tpu/index/pallas_adc.py:89",
        "replaces_function": "_adc_onehot_kernel via adc_scores_pallas",
        "launches": launches["adc_scan"], "max_abs_err": worst,
        "ms": chunk["ms"], "plain_ms": chunk["plain_ms"],
        "bound_ms": chunk["bound_ms"], "bound_by": chunk["bound_by"],
        "library_ms": None,
        "shape": {"Q": 1200, "N": 1 << 17, "M": 12, "K": 256}}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
