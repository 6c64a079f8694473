#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (repconc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (flushed, with elapsed_s), so that a cut run
shows where it stopped:

  0 device      no GPU -> exit 1 at once; the card's name and power limit
  1 build       nvcc builds every kernel, all sources at once: K1
                csrc/adc_scan.cu, K2 and K3 csrc/ivf_scan.cu, K4
                csrc/adc_scan_i8.cu; ptxas registers and spills
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
  5 k2_check, k3_check, k4_check
                K2 / K3 (cell-grouped IVF scan, bf16 / int8 LUT) and K4 (int8
                brute-force scan) against their plain versions, at the IVF
                bench geometry (M=48, nlist=4096, Lpad=256, Q=1200,
                nprobe=64, pairs from a real probe), an M=12 layout with
                Lpad=2048, Lpad=640 and a single occupied slot: scores to
                rtol=atol=1e-5; kernel, plain and bound times
  6 ivf_scale   IVF-PQ over 8,841,823 random M=12 codes: build_ivf_from_codes
                (nlist=4096) on the card, then serve_search of 1200 queries,
                nprobe=64, top-1000, bf16 and int8 LUTs; checks that the
                scores re-sum with each run's own LUT (int8 and its scales
                for the cells' docs, bf16 for the spill, which K1 scans),
                the ids lie in probed cells or the spill, the
                top-1000 of 64 queries is the exact top-1000 of their probed
                cells and the spill, and int8 top-100 overlaps bf16's
  7 ivf_main_path
                the CLI's own IVF branch (run_repconc_eval.search_ivf) on
                phase 4's codes and query embeddings, nlist=64: at full probe
                the ranking equals the flat K1 ranking except near-ties; the
                int8 LUT run and nprobe=8 recall; every run's scores
                re-summed as in phase 6; TREC run written and scored
  8 kernels     one JSON line per the port's kernel table

The last lines are the kernels line, the card's `nvidia-smi` name and power
limit, and {"ok": true, "device": {...}}. Any failure raises and exits
non-zero. The script writes only to a temporary directory and to the
package's _build/ directory. It imports torch, numpy, the standard library
and repconc_tpu_torch; nothing of JAX.
"""
from __future__ import annotations

import argparse
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
SOURCES = ("adc_scan.cu", "ivf_scan.cu", "adc_scan_i8.cu")


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
    reset_launches()
    run, codes, corpus_ids, query_ids = repconc_retrieval(
        model, tok, corpus, queries, max_seq_length=max_len, topk=topk,
        encode_batch=256, search_batch=1200, device=dev, stopwatch=sw)
    torch.cuda.synchronize()
    launches = launch_counts()
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
    return dict(launches=launches, codes=codes, corpus_ids=corpus_ids,
                query_ids=query_ids, q_embeds=q_embeds, qrels=qrels,
                centroids=model.centroids.detach().cpu().numpy(), plain=plain)


def bound_ms(nbytes: float, adds: float):
    """(least time in ms, "bytes" or "operations") on an H100 SXM: the
    bytes over HBM's rate against the adds at the fp32 rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = adds / H100_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ivf_bound(work_cell, qidx, Qz: int, Lpad: int, M: int, K: int,
              lut_bytes: int, G: int = 0):
    """Least time of one K2 / K3 call on this run's tiles: each distinct
    cell that an occupied tile scores has its codes read ONCE
    (cells * Lpad * M), each query's LUT read ONCE ((Q + 1) * M * K entries,
    + scales) and the (T, 32, Lpad) f32 scores written once, against
    occupied slots * Lpad * M adds (an empty slot's zeros need none). The
    kernel re-reads a cell's codes for every tile of that cell and a
    query's LUT for every tile the query is in; the bound counts each once."""
    import torch

    T, slots = qidx.shape
    occupied = qidx != Qz - 1
    cells = torch.unique(work_cell[occupied.any(1)]).numel()
    nbytes = (cells * Lpad * M + Qz * M * K * lut_bytes + Qz * G * 4
              + T * slots * Lpad * 4)
    return bound_ms(nbytes, int(occupied.sum()) * Lpad * M)


def ivf_geometry(dev, Q, nlist, nprobe, D, seed):
    """Work tiles from a real probe: random coarse centroids and queries,
    probe_cells, then the exact-grid grouping."""
    import torch
    from repconc_tpu_torch.index.cuda_ivf import group_pairs
    from repconc_tpu_torch.index.ivf import probe_cells

    g = torch.Generator(device=dev).manual_seed(seed)
    coarse = torch.randn((nlist, D), generator=g, device=dev)
    q = torch.randn((Q, D), generator=g, device=dev)
    cells = probe_cells(q, coarse, nprobe)
    _, work_cell, qidx, overflow = group_pairs(cells, Q, nlist, nprobe)
    check(int(overflow) == 0, "exact tile grid drops no pair")
    return work_cell, qidx


def phase_ivf_checks(dev):
    """K2, K3 and K4 against their plain versions on the card."""
    import torch
    from repconc_tpu_torch.index.adc import (group_size, quantize_lut_int8,
                                             score_codes_int8_reference)
    from repconc_tpu_torch.index.cuda_adc import adc_scores_int8
    from repconc_tpu_torch.index.cuda_ivf import (QT_G, score_work_tiles,
                                                  score_work_tiles_reference)

    K = 256
    cases = [  # name, Q, nlist, nprobe, Lpad, M
        ("bench", 1200, 4096, 64, 256, 48),
        ("m12_lpad2048", 1200, 1024, 64, 2048, 12),
        ("lpad640", 256, 256, 16, 640, 12),
        ("one_slot", 1, 8, 1, 256, 12),
    ]
    results = {"ivf_scan_bf16": {}, "ivf_scan_i8": {}, "adc_scan_i8": {}}
    for name, Q, nlist, nprobe, Lpad, M in cases:
        seed = SEED + Q + nlist + Lpad + M
        g = torch.Generator(device=dev).manual_seed(seed)
        if name == "one_slot":
            work_cell = torch.tensor([3], dtype=torch.int32, device=dev)
            qidx = torch.full((1, QT_G), Q, dtype=torch.int32, device=dev)
            qidx[0, 0] = 0
        else:
            work_cell, qidx = ivf_geometry(dev, Q, nlist, nprobe, 16 * M, seed)
        T = work_cell.shape[0]
        codes = torch.randint(0, K, (nlist, Lpad, M), generator=g, device=dev,
                              dtype=torch.uint8)
        lut = torch.randn((Q, M, K), generator=g, device=dev)
        gm = group_size(M, K)
        lut_i8, scales = quantize_lut_int8(lut, gm)
        zrow = lambda a: torch.cat([a, a.new_zeros((1,) + a.shape[1:])]).contiguous()  # noqa: E731
        variants = {
            "ivf_scan_bf16": (zrow(lut.to(torch.bfloat16)), None, 2, 0),
            "ivf_scan_i8": (zrow(lut_i8), zrow(scales), 1, M // gm),
        }
        empty = qidx == Q
        for kname, (lut_z, scales_z, b, G) in variants.items():
            run = lambda: score_work_tiles(work_cell, qidx, lut_z, codes,  # noqa: E731
                                           scales_z)
            got = run()
            want = score_work_tiles_reference(work_cell, qidx, lut_z, codes,
                                              scales_z)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, rtol=ADC_TOL, atol=ADC_TOL)
            check(bool((got[empty] == 0).all()), f"{kname} empty slots are 0")
            ms = time_ms(run)
            plain_ms = time_ms(lambda: score_work_tiles_reference(
                work_cell, qidx, lut_z, codes, scales_z), reps=3, warmup=1)
            b_ms, b_by = ivf_bound(work_cell, qidx, Q + 1, Lpad, M, K, b, G)
            res = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       max_abs_err=err, shape=dict(T=T, Q=Q, nlist=nlist,
                                                   nprobe=nprobe, Lpad=Lpad,
                                                   M=M, K=K))
            results[kname][name] = res
            emit("k2_check" if kname == "ivf_scan_bf16" else "k3_check",
                 case=name, occupied_slots=int((~empty).sum()),
                 library_ms=None, **res)
            del got, want
        del codes, lut, lut_i8, scales, variants
        torch.cuda.empty_cache()

    for Q, N, M in [(1200, 1 << 17, 12), (129, 100_003, 48), (1, 1000, 12),
                    (37, 5003, 12)]:
        g = torch.Generator(device=dev).manual_seed(SEED + Q + N + M)
        lut_i8, scales = quantize_lut_int8(
            torch.randn((Q, M, K), generator=g, device=dev), group_size(M, K))
        codes = torch.randint(0, K, (N, M), generator=g, device=dev,
                              dtype=torch.uint8)
        got = adc_scores_int8(lut_i8, scales, codes)
        want = score_codes_int8_reference(lut_i8, scales, codes)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=ADC_TOL, atol=ADC_TOL)
        ms = time_ms(lambda: adc_scores_int8(lut_i8, scales, codes))
        plain_ms = time_ms(lambda: score_codes_int8_reference(
            lut_i8, scales, codes), reps=3, warmup=1)
        G = scales.shape[1]
        b_ms, b_by = bound_ms(N * M + Q * M * K + Q * G * 4 + Q * N * 4,
                              Q * N * M)
        res = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   max_abs_err=err, shape=dict(Q=Q, N=N, M=M, K=K))
        results["adc_scan_i8"][(Q, N, M)] = res
        emit("k4_check", library_ms=None, **res)
        del lut_i8, scales, codes, got, want
        torch.cuda.empty_cache()
    return results


def launch_counts():
    from repconc_tpu_torch.index.cuda_adc import adc_scores, adc_scores_int8
    from repconc_tpu_torch.index.cuda_ivf import score_work_tiles

    return {"adc_scan": adc_scores.launches,
            "ivf_scan_bf16": score_work_tiles.launches["bf16"],
            "ivf_scan_i8": score_work_tiles.launches["int8"],
            "adc_scan_i8": adc_scores_int8.launches}


def reset_launches():
    from repconc_tpu_torch.index.cuda_adc import adc_scores, adc_scores_int8
    from repconc_tpu_torch.index.cuda_ivf import score_work_tiles

    adc_scores.launches = 0
    adc_scores_int8.launches = 0
    score_work_tiles.launches = {"bf16": 0, "int8": 0}


def resum_check(queries, centroids, codes, scores, ids, spill_ids,
                lut_dtype: str, what: str) -> float:
    """Check (a): every returned finite score equals the plain re-sum of
    that doc's codes with the search's own LUT: the int8 LUT and its scales
    (score_codes_int8_reference) for a cell's doc when lut_dtype is int8,
    else, and always for a spill doc (K1 scans the spill), the bf16 LUT.
    Returns the max abs error."""
    import torch
    from repconc_tpu_torch.index.adc import (build_lut, group_size,
                                             quantize_lut_int8,
                                             score_codes_int8_reference)

    lut = build_lut(queries, centroids)
    Q, M, K = lut.shape
    rows = ids.clamp(min=0)
    picked = codes[rows].long()                        # (Q, k, M)
    lut_f = lut.to(torch.bfloat16).float()
    want = torch.zeros_like(scores)
    for m in range(M):
        want += lut_f[:, m].gather(1, picked[:, :, m])
    if lut_dtype == "int8":
        lut_i8, scales = quantize_lut_int8(lut, group_size(M, K))
        i8 = torch.stack([score_codes_int8_reference(
            lut_i8[r:r + 1], scales[r:r + 1], codes[rows[r]])[0]
            for r in range(Q)])
        want = torch.where(torch.isin(ids, spill_ids), want, i8)
    ok = torch.isfinite(scores)
    err = float((want - scores)[ok].abs().max())
    check(bool(ok.any()) and err <= ADC_TOL,
          f"{what} (a): returned {lut_dtype} scores re-summed ({err})")
    return err


def topk_overlap(i_a, i_b) -> float:
    """Mean share of each row of i_a found in the same row of i_b."""
    return float((i_a[:, :, None] == i_b[:, None, :]).any(-1).float().mean())


def phase_ivf_scale(dev):
    """IVF-PQ serving at MS MARCO's passage count with the CLI's defaults."""
    import torch
    from repconc_tpu_torch.core.profiling import Stopwatch
    from repconc_tpu_torch.index.adc import build_lut, score_codes_reference
    from repconc_tpu_torch.index.ivf import (build_ivf_from_codes, probe_cells,
                                             serve_search)

    M, K, D, Q, topk, nlist, nprobe = 12, 256, 768, 1200, 1000, 4096, 64
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    codes = torch.randint(0, K, (MSMARCO_PASSAGES, M), generator=g, device=dev,
                          dtype=torch.uint8)
    cent = torch.randn((M, K, D // M), generator=g, device=dev)
    queries = torch.randn((Q, D), generator=g, device=dev)
    cent_np, q_np = cent.cpu().numpy(), queries.cpu().numpy()
    sw = Stopwatch()
    t = time.perf_counter()
    index = build_ivf_from_codes(codes, cent_np, nlist=nlist, device=dev,
                                 stopwatch=sw)
    build_s = time.perf_counter() - t
    check(index.ntotal == MSMARCO_PASSAGES, "ivf: every doc in a cell or spill")
    emit("ivf_build", N=MSMARCO_PASSAGES, nlist=nlist, Lpad=index.Lpad,
         spill=len(index.spill_ids), build_s=build_s,
         kmeans_s=sw.totals["ivf_kmeans"], assign_s=sw.totals["ivf_assign"],
         fill_s=sw.totals["ivf_fill"],
         cell_size_mean=float(index.cell_sizes.mean()),
         cell_size_max=int(index.cell_sizes.max()))

    searches = {}
    for lut_dtype in ("bf16", "int8"):
        # the first call at full size grows the caching allocator by ~15 GB
        # (the score buffer and the candidates at Lpad ~8.7k): timed apart
        times = []
        for _ in range(3):
            reset_launches()
            t = time.perf_counter()
            s, i = serve_search(index, q_np, topk=topk, nprobe=nprobe,
                                lut_dtype=lut_dtype, device=dev)
            times.append(time.perf_counter() - t)
        searches[lut_dtype] = (torch.as_tensor(s, device=dev),
                               torch.as_tensor(i, device=dev).long(),
                               times, launch_counts())
    spill_ids = torch.as_tensor(index.spill_ids, device=dev).long()
    cell_ids = torch.as_tensor(index.cell_ids, device=dev).long()
    cell_of = torch.full((MSMARCO_PASSAGES,), -1, dtype=torch.long, device=dev)
    valid = cell_ids >= 0
    cell_of[cell_ids[valid]] = torch.arange(
        nlist, device=dev)[:, None].expand_as(cell_ids)[valid]
    in_spill = torch.zeros(MSMARCO_PASSAGES, dtype=torch.bool, device=dev)
    in_spill[spill_ids] = True
    coarse = torch.as_tensor(index.coarse_centroids, device=dev)
    cells = probe_cells(queries, coarse, nprobe)
    errs_a = {}
    for lut_dtype, (s, i, _, _) in searches.items():
        what = f"ivf {lut_dtype}"
        check(tuple(s.shape) == (Q, topk) and bool(torch.isfinite(s).all()),
              f"{what}: finite (Q, topk) scores")
        check(bool((s[:, :-1] >= s[:, 1:]).all()), f"{what}: sorted scores")
        # (a) every returned score is the plain re-sum of that doc's codes
        errs_a[lut_dtype] = resum_check(queries, cent, codes, s, i, spill_ids,
                                        lut_dtype, what)
        # (b) every returned id lies in a probed cell of its query or the spill
        probed = (cell_of[i][:, :, None] == cells[:, None, :]).any(-1)
        check(bool((probed | in_spill[i]).all()),
              f"{what} (b): ids in a probed cell or the spill")
        del probed
    s, i, _, _ = searches["bf16"]
    lut = build_lut(queries, cent).to(torch.bfloat16)
    # (c) 64 queries: the exact top-1000 of their probed cells and the spill
    nq = 64
    plain = score_codes_reference(lut[:nq].contiguous(), codes)   # (64, N)
    allowed = in_spill[None, :].repeat(nq, 1)
    members = cell_ids[cells[:nq]].reshape(nq, -1)
    rows = torch.arange(nq, device=dev)[:, None].expand_as(members)
    ok = members >= 0
    allowed[rows[ok], members[ok]] = True
    plain = torch.where(allowed, plain, -torch.inf)
    check(topk_agree(s[:nq], i[:nq], plain, ADC_TOL),
          "ivf (c): top-1000 of 64 queries equals the exact top-1000 of "
          "their probed cells and the spill, except near-ties")
    del plain, allowed, members, rows, ok
    # (d) the int8 LUT's top-100 overlaps the bf16 top-100
    s8, i8 = searches["int8"][:2]
    overlap = topk_overlap(i8[:, :100], i[:, :100])
    check(overlap >= 0.9, f"ivf (d): int8 top-100 overlap {overlap} >= 0.9")
    out = {}
    for lut_dtype, (_, _, times, launches) in searches.items():
        steady = statistics.median(times[1:])
        out[lut_dtype] = dict(first_search_s=times[0], search_s=times[1:],
                              queries_per_s=Q / steady, launches=launches)
    breakdown = ivf_breakdown(index, queries, nprobe, topk)
    emit("ivf_scale", N=MSMARCO_PASSAGES, M=M, K=K, Q=Q, topk=topk,
         nlist=nlist, nprobe=nprobe, Lpad=index.Lpad,
         spill=len(index.spill_ids), searches=out, rescore_max_abs_err=errs_a,
         int8_top100_overlap=overlap, breakdown_ms=breakdown)
    del searches, s, i, s8, i8, codes, cell_ids, cell_of, valid, in_spill, lut
    del index
    torch.cuda.empty_cache()
    return out


def ivf_breakdown(index, queries, nprobe: int, topk: int):
    """Where one bf16 IVF search of the batch spends its time: each step of
    CudaIVFIndex.search_device timed alone (CUDA events, median of 3)."""
    import torch
    from repconc_tpu_torch.index import cuda_ivf
    from repconc_tpu_torch.index.ivf import probe_cells

    ivf = cuda_ivf.CudaIVFIndex(index, device=queries.device)
    Q, nlist, Lpad = queries.shape[0], ivf.nlist, ivf.cell_codes.shape[1]
    cells = probe_cells(queries, ivf.coarse, nprobe)
    row, work_cell, qidx, _ = cuda_ivf.group_pairs(cells, Q, nlist, nprobe)
    lut_z, _ = cuda_ivf.make_lut_z(queries, ivf.centroids)
    scores = cuda_ivf.score_work_tiles(work_cell, qidx, lut_z, ivf.cell_codes)
    flat = scores.reshape(-1, Lpad)
    s, i = cuda_ivf.regroup_topk(flat, row, cells, ivf.cell_ids, Q, nprobe,
                                 topk)
    steps = {
        "probe": lambda: probe_cells(queries, ivf.coarse, nprobe),
        "group_pairs": lambda: cuda_ivf.group_pairs(cells, Q, nlist, nprobe),
        "lut": lambda: cuda_ivf.make_lut_z(queries, ivf.centroids),
        "k2_scan": lambda: cuda_ivf.score_work_tiles(work_cell, qidx, lut_z,
                                                     ivf.cell_codes),
        "regroup_topk": lambda: cuda_ivf.regroup_topk(
            flat, row, cells, ivf.cell_ids, Q, nprobe, topk),
        "spill_k1_merge": lambda: cuda_ivf.merge_spill(
            s, i, ivf.spill, ivf.spill_ids, queries, topk),
        "whole_search": lambda: ivf.search_device(queries, topk, nprobe),
    }
    out = {name: time_ms(fn, reps=3, warmup=1) for name, fn in steps.items()}
    out["tiles"] = int(work_cell.shape[0])
    out["score_buffer_gb"] = scores.numel() * 4 / 1e9
    del ivf, scores, flat, s, i
    torch.cuda.empty_cache()
    return out


def phase_ivf_main_path(dev, main):
    """The CLI's IVF branch on phase 4's codes and query embeddings."""
    import numpy as np
    import torch
    from repconc_tpu_torch.cli.run_repconc_eval import search_ivf
    from repconc_tpu_torch.core.profiling import Stopwatch
    from repconc_tpu_torch.eval.run_io import write_run_tsv
    from repconc_tpu_torch.eval.trec import evaluate_run

    codes, corpus_ids, query_ids, q_embeds, centroids, plain, qrels = (
        main[k] for k in ("codes", "corpus_ids", "query_ids", "q_embeds",
                          "centroids", "plain", "qrels"))
    row_of = {cid: j for j, cid in enumerate(corpus_ids)}
    topk = 1000
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, nprobe, lut_dtype in (("full_bf16", 64, "bf16"),
                                        ("full_int8", 64, "int8"),
                                        ("probe8_bf16", 8, "bf16")):
            args = argparse.Namespace(nlist=64, nprobe=nprobe, topk=topk,
                                      search_batch=1200, serving="auto",
                                      lut_dtype=lut_dtype)
            sw = Stopwatch()
            reset_launches()
            scores, docids = search_ivf(codes, corpus_ids, q_embeds,
                                        centroids, tmp, args, dev, sw)
            torch.cuda.synchronize()
            launches = launch_counts()
            run_path = os.path.join(tmp, f"run_{name}.tsv")
            write_run_tsv(run_path, query_ids, scores, docids)
            ids = torch.tensor([[row_of[d] for d in r] for r in docids],
                               device=dev)
            ids[~torch.isfinite(torch.as_tensor(scores, device=dev))] = -1
            runs[name] = dict(launches=launches, ids=ids,
                              scores=torch.as_tensor(scores, device=dev),
                              run_path=run_path,
                              build_s=sw.totals.get("build_ivf", 0.0),
                              search_s=sw.totals["search"])
        qrel_path = os.path.join(tmp, "qrels.tsv")
        with open(qrel_path, "w") as f:
            f.writelines(f"{q} 0 {d} {r}\n" for q, ds in qrels.items()
                         for d, r in ds.items())
        for r in runs.values():
            m = evaluate_run(qrel_path, r["run_path"], k_values=(10, 100, 1000),
                             mrr_k_values=(10,))
            r["mrr_at_10"] = m["mrr"]["MRR@10"]
            r["recall_at_1000"] = m["recall"]["Recall@1000"]
        from repconc_tpu_torch.index.ivf import IVFIndex

        index = IVFIndex.load(tmp)
    full = runs["full_bf16"]
    check(full["launches"]["ivf_scan_bf16"] > 0, "ivf main path launched K2")
    check(runs["full_int8"]["launches"]["ivf_scan_i8"] > 0,
          "ivf main path (int8 LUT) launched K3")
    check(topk_agree(full["scores"], full["ids"], plain, ADC_TOL),
          "ivf full probe ranks as the flat K1 scan, except near-ties")
    q_dev = torch.as_tensor(q_embeds, dtype=torch.float32, device=dev)
    cent_dev = torch.as_tensor(centroids, dtype=torch.float32, device=dev)
    codes_dev = torch.as_tensor(codes, device=dev)
    spill_ids = torch.as_tensor(index.spill_ids, device=dev).long()
    resum_err = {name: resum_check(q_dev, cent_dev, codes_dev, r["scores"],
                                   r["ids"], spill_ids, lut_dtype,
                                   f"ivf main path {name}")
                 for name, r, lut_dtype in (
                     ("full_bf16", full, "bf16"),
                     ("full_int8", runs["full_int8"], "int8"),
                     ("probe8_bf16", runs["probe8_bf16"], "bf16"))}
    _, flat_i = torch.topk(plain, topk, dim=1)
    p8 = runs["probe8_bf16"]
    recall8 = topk_overlap(flat_i, p8["ids"])
    int8_overlap = topk_overlap(runs["full_int8"]["ids"][:, :100],
                                full["ids"][:, :100])
    emit("ivf_main_path", nlist=index.nlist, Lpad=index.Lpad,
         spill=len(index.spill_ids), docs=len(corpus_ids),
         queries=len(query_ids),
         runs={k: {f: v[f] for f in ("launches", "build_s", "search_s",
                                     "mrr_at_10", "recall_at_1000")}
               for k, v in runs.items()},
         recall_at_1000_vs_flat_nprobe8=recall8,
         int8_top100_overlap=int8_overlap, rescore_max_abs_err=resum_err)
    return {k: v["launches"] for k, v in runs.items()}


def build_all():
    """nvcc on every source at once, one thread each (each build is its
    own process); one build line per source with ptxas's registers and
    spills."""
    from concurrent.futures import ThreadPoolExecutor

    from repconc_tpu_torch import build

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        builds = list(pool.map(build.build, SOURCES))
    for source, b in zip(SOURCES, builds):
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln]
        emit("build", source=source, seconds=b.seconds, library=b.path.name,
             ptxas=ptxas)


KERNELS = [  # name, source, replaces, the TPU function
    ("adc_scan", "repconc_tpu_torch/csrc/adc_scan.cu",
     "repconc_tpu/index/pallas_adc.py:89",
     "_adc_onehot_kernel via adc_scores_pallas"),
    ("ivf_scan_bf16", "repconc_tpu_torch/csrc/ivf_scan.cu",
     "repconc_tpu/index/pallas_ivf.py:90",
     "_ivf_kernel via _score_work_tiles"),
    ("ivf_scan_i8", "repconc_tpu_torch/csrc/ivf_scan.cu",
     "repconc_tpu/index/pallas_ivf.py:112",
     "_ivf_kernel_i8 via _score_work_tiles"),
    ("adc_scan_i8", "repconc_tpu_torch/csrc/adc_scan_i8.cu",
     "repconc_tpu/index/pallas_adc.py:107",
     "_adc_onehot_kernel_i8 via adc_scores_pallas_int8"),
]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no GPU found (torch.cuda.is_available() is False)",
              file=sys.stderr, flush=True)
        return 1
    from repconc_tpu_torch.core.device import resolve_device

    dev = resolve_device("cuda")
    card = card_line()
    emit("device", name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)
    build_all()

    k1, worst = phase_k1_check(dev)
    checks = phase_ivf_checks(dev)
    phase_full_scan(dev)
    ivf_scale = phase_ivf_scale(dev)
    main_path = phase_main_path(dev)
    ivf_runs = phase_ivf_main_path(dev, main_path)

    # launches on the paths: K1 on the flat main path (phase 4), K2 on the
    # IVF path with the bf16 LUT and K3 on it with the int8 LUT (phase 7).
    # K4 is on no path (none in the JAX package either): its launches there
    # must stay 0, and k4_check holds it against its plain version
    launches = {
        "adc_scan": (main_path["launches"]["adc_scan"], "main_path"),
        "ivf_scan_bf16": (ivf_runs["full_bf16"]["ivf_scan_bf16"],
                          "ivf_main_path full_bf16"),
        "ivf_scan_i8": (ivf_runs["full_int8"]["ivf_scan_i8"],
                        "ivf_main_path full_int8"),
        "adc_scan_i8": (sum(r["adc_scan_i8"] for r in ivf_runs.values())
                        + sum(r["launches"]["adc_scan_i8"]
                              for r in ivf_scale.values()), None),
    }
    timed = {
        "adc_scan": dict(k1[(1200, 1 << 17, 12)], max_abs_err=worst,
                         shape={"Q": 1200, "N": 1 << 17, "M": 12, "K": 256}),
        "ivf_scan_bf16": checks["ivf_scan_bf16"]["bench"],
        "ivf_scan_i8": checks["ivf_scan_i8"]["bench"],
        "adc_scan_i8": checks["adc_scan_i8"][(1200, 1 << 17, 12)],
    }
    for name in ("ivf_scan_bf16", "ivf_scan_i8", "adc_scan_i8"):
        timed[name] = dict(timed[name], max_abs_err=max(
            r["max_abs_err"] for r in checks[name].values()))
    line = []
    for name, source, replaces, function in KERNELS:
        n, path = launches[name]
        if path is None:
            check(n == 0, f"{name}, on no path, was not launched on one")
        else:
            check(n > 0, f"{name} launched on its path ({path})")
        t = timed[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "replaces_function": function,
                     "launches": n, "launches_in": path,
                     "on_path": path is not None,
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None,
                     "shape": t["shape"]})
    print(json.dumps({"kernels": line}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
