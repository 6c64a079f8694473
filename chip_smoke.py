#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (repconc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (flushed, with elapsed_s), so that a cut run
shows where it stopped:

  0 device      no GPU -> exit 1 at once; the card's name and power limit
  1 build       nvcc builds every kernel, all sources at once: K1
                csrc/adc_scan.cu, K2 and K3 and their passes
                csrc/ivf_scan.cu, K4
                csrc/adc_scan_i8.cu; ptxas registers and spills
  2 k1_check    K1 against its plain PyTorch version on the card, at M=12
                (Q x N grid), M=48, M=96 and one chunk of the full scan:
                scores to rtol=atol=1e-5, top-1000 ids equal except
                near-ties (< 1e-5 apart); kernel, plain and bound times
  2b k1_topk_check
                the two passes of the fused top-k (adc_group_max,
                adc_filter) against their plain versions: gmax bit for bit,
                the same candidate sets with bit-equal scores, the same
                counts, at M=12, 48, 96 (Q=129, N=100,003, pad docs
                present), with exact ties at tau (a forced rerun of pass
                2), and at the full scan's shapes; adc_topk against K1 and
                torch.topk; ms, plain ms, bound, reruns
  3 full_scan   CudaADCIndex over 8,841,823 random M=12 codes (MS MARCO's
                passage count), 1200-query top-1000 searches through
                adc_topk: 64 queries held to the chunked K1 + torch.topk
                path (ids equal except exact ties, scores bit-equal), the
                re-sum check, the time of each step, the chunked path and
                the embedding_bag yardsticks timed in the same run, and a
                sweep over the number of groups
  4 main_path   repconc_retrieval at bert-base width (the M=12 checkpoint's
                config, seeded random weights) over 65,536 synthetic docs and
                256 queries, on the card; launch counts read around it;
                ranking checked against the plain scorer, 8 docs checked
                against the CPU (proves TF32 is off), TREC run written and
                scored
  5 k2_check, k3_check, k4_check
                K2 / K3 (cell-grouped IVF scan writing every score, bf16 /
                int8 LUT) and K4 (int8 brute-force scan) against their plain
                versions, at the IVF bench geometry (M=48, nlist=4096,
                Lpad=256, Q=1200, nprobe=64, pairs from a real probe), an
                M=12 layout with Lpad=2048, Lpad=640 and a single occupied
                slot: scores to rtol=atol=1e-5; kernel, plain and bound
                times, and the LUT bytes each tile re-stages
  5b ivf_topk_check
                the two passes of the fused IVF top-k (ivf_group_max,
                ivf_filter), bf16 and int8, against their plain versions
                (gmax bit for bit, the same candidate sets with bit-equal
                scores, the same counts) at M=48 (the bench geometry, where
                pass 1 is skipped), M=12 with Lpad=2048, exact ties that
                force a rerun, and tau = -inf; ivf_topk against K2 / K3 +
                regroup_topk (scores bit for bit, ids except tie order);
                ms, plain ms, bound, candidates, reruns
  6 ivf_scale   IVF-PQ over 8,841,823 random M=12 codes: build_ivf_from_codes
                (nlist=4096) on the card, then serve_search of 1200 queries,
                nprobe=64, top-1000, bf16 and int8 LUTs; checks that the
                scores re-sum with each run's own LUT (int8 and its scales
                for the cells' docs, bf16 for the spill, which adc_topk
                scans), the ids lie in probed cells or the spill, the
                top-1000 of 64 queries is the exact top-1000 of their probed
                cells and the spill, and int8 top-100 overlaps bf16's; the
                breakdown holds the fused top-k to K2 / K3 + regroup_topk on
                all 1200 queries, times each step of both, and reads the
                peak device memory of one search of each
  7 ivf_main_path
                the CLI's own IVF branch (run_repconc_eval.search_ivf) on
                phase 4's codes and query embeddings, nlist=64, through the
                two IVF passes (K2 / K3 unfused: 0 launches): at full probe
                the ranking equals the flat ranking except near-ties; the
                int8 LUT run and nprobe=8 recall; every run's scores
                re-summed as in phase 6; TREC run written and scored
  8 train_stage1
                stage-1 training at full width (the M=12 config, seeded
                weights, the CLI's defaults: 64 queries + 64 positives + 64
                random negatives a step, lengths 16 / 128, the Sinkhorn
                constraint at eps 0.003 and 100 iterations) through
                train/stage1.py::train: 10 steps, saves every 5, one
                validation over 8,192 docs and 256 queries through the flat
                search, where both passes of K1 must launch; finite losses,
                final/params.msgpack read back equal to the model, a second
                train call resumes and stops at once, one step's
                constrained codes card == CPU except near-ties, an 8-query
                step (argmin codes) card == CPU; the median step time,
                training queries/s
                and docs/s, the step split into encoder, Sinkhorn, decode +
                loss and optimizer (CUDA events), peak memory, validation s
  9 kernels     one JSON line per the port's kernel table

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


def bound_ms(nbytes: float, adds: float):
    """(least time in ms, "bytes" or "operations") on an H100 SXM: the
    bytes over HBM's rate against the adds at the fp32 rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = adds / H100_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def adc_bound(Q: int, N: int, M: int, K: int):
    """Least time for the scan's work on an H100 SXM: codes, LUT and scores
    moved once over HBM, against Q*N*M f32 adds."""
    return bound_ms(N * M + Q * M * K * 2 + Q * N * 4, Q * N * M)


def pass_bounds(gmax, tau, count, N: int, M: int, K: int, topk: int):
    """Least times of pass 1, pass 2 and the whole search on this run's
    inputs. Pass 1: codes and LUT read once, gmax written, Q*N*M adds.
    Pass 2: the codes of the groups some query needs, the LUT, gmax and tau
    read once, the candidates written (12 bytes each), and the adds of each
    query's groups that reach its tau (what this data needs). The search:
    codes and LUT read, top-k written, Q*N*M adds."""
    import torch
    from repconc_tpu_torch.index.adc import doc_groups

    Q, G = gmax.shape
    lut_bytes = Q * M * K * 2
    docs = torch.bincount(doc_groups(N, G, gmax.device), minlength=G).double()
    need = gmax >= tau[:, None]
    adds2 = float((need.double() @ docs).sum()) * M
    codes2 = float(docs[need.any(0)].sum()) * M
    return {
        "pass1": bound_ms(N * M + lut_bytes + Q * G * 4, Q * N * M),
        "pass2": bound_ms(codes2 + lut_bytes + Q * G * 4 + Q * 4
                          + float(count.sum()) * 12 + Q * 4, adds2),
        "search": bound_ms(N * M + lut_bytes + Q * topk * 12, Q * N * M),
        "pass2_adds_share": adds2 / (Q * N * M),
    }


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
    import torch.nn.functional as F
    from repconc_tpu_torch.index.adc import score_codes_reference
    from repconc_tpu_torch.index.cuda_adc import adc_scores

    shapes = [(Q, N, 12) for Q in (1, 129, 1200)
              for N in (1, 1000, 100_003, 1_048_576)]
    shapes += [(129, 100_003, 48), (129, 100_003, 96),
               (256, 65_536, 12),      # the main path's corpus (phase 4)
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
        res = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, max_abs_err=err)
        if (Q, N, M) == (1200, 1 << 17, 12):
            # one library call computing the same function, transposed:
            # the (M * K, Q) f32 LUT summed over each doc's M rows
            weight = lut.float().reshape(Q, M * K).T.contiguous()
            bag = codes.long() + torch.arange(M, device=dev) * K
            res["library_ms"] = time_ms(
                lambda: F.embedding_bag(bag, weight, mode="sum"))
            res["library_max_abs_err"] = float(
                (F.embedding_bag(bag, weight, mode="sum").T - got).abs().max())
            res["library_call"] = ("torch.nn.functional.embedding_bag(codes + "
                                   "m * K, lut (M * K, Q) f32, mode='sum')")
            del weight, bag
        results[(Q, N, M)] = res
        emit("k1_check", Q=Q, N=N, M=M, K=K, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
             library_ms=res.get("library_ms"),
             library_max_abs_err=res.get("library_max_abs_err"))
        del lut, codes, got, want, s_got, i_got
        torch.cuda.empty_cache()
    return results, worst


def same_candidates(got, want, what: str, plain=None) -> None:
    """Pass 2 on the card (got) against its plain version (want), each
    (cand_s, cand_i, count): equal counts; min(count, cap) slots filled and
    the rest -inf / -1; where count <= cap the same ids with bit-equal
    scores (the kernel stores them in arrival order); past cap, distinct ids
    whose scores are, where `plain(r, ids)` gives them, their plain scores."""
    import torch

    (s_g, i_g, c_g), (s_w, i_w, c_w) = got, want
    check(torch.equal(c_g, c_w), f"{what}: counts equal")
    cap = s_g.shape[1]
    filled = (torch.arange(cap, device=s_g.device)[None, :]
              < c_w.clamp(max=cap)[:, None].long())
    check(bool(((i_g >= 0) == filled).all())
          and bool((torch.isneginf(s_g) | filled).all()),
          f"{what}: min(count, cap) slots filled, the rest -inf / -1")
    big = torch.iinfo(torch.long).max

    def by_id(s, i):
        ids, perm = torch.sort(torch.where(filled, i, big), dim=1)
        return torch.gather(s, 1, perm), ids

    (s_gs, ids_g), (s_ws, ids_w) = by_id(s_g, i_g), by_id(s_w, i_w)
    under = c_w <= cap
    check(torch.equal(ids_g[under], ids_w[under])
          and torch.equal(s_gs[under], s_ws[under]),
          f"{what}: candidate sets equal, scores bit-equal")
    for r in torch.nonzero(~under).flatten().tolist():
        ids = ids_g[r]
        check(bool((ids[1:] != ids[:-1]).all()), f"{what}: distinct ids")
        if plain is not None:
            check(torch.equal(plain(r, ids), s_gs[r]),
                  f"{what}: past cap, plain scores")


def plain_in_slices(fn, Q: int, rows: int):
    """A plain version over query slices of `rows` (its (Q, N) temporaries
    do not fit the card at the full scan's size), results concatenated."""
    import torch

    parts = [fn(slice(q, min(q + rows, Q))) for q in range(0, Q, rows)]
    return tuple(torch.cat(p) for p in zip(*parts)) if isinstance(
        parts[0], tuple) else torch.cat(parts)


def phase_k1_topk_check(dev):
    """adc_group_max and adc_filter against their plain versions; adc_topk
    against a top-k over K1's scores."""
    import torch
    from repconc_tpu_torch.index.adc import (adc_filter_reference,
                                             adc_group_max_reference,
                                             score_codes_reference)
    from repconc_tpu_torch.index.cuda_adc import (adc_filter, adc_group_max,
                                                  adc_scores, adc_topk,
                                                  search_plan)

    K, topk = 256, 1000
    cases = [  # name, Q, N, M, pad rows, distinct rows (0: all random)
        ("m12", 129, 100_003, 12, 77, 0),
        ("m48", 129, 100_003, 48, 77, 0),
        ("m96", 129, 100_003, 96, 77, 0),
        ("ties", 129, 100_003, 12, 77, 40),
        ("full", 1200, MSMARCO_PASSAGES, 12, 0, 0),
    ]
    results = {}
    for name, Q, N, M, npad, distinct in cases:
        g = torch.Generator(device=dev).manual_seed(SEED + Q + N + M + distinct)
        lut = torch.randn((Q, M, K), generator=g, device=dev).to(torch.bfloat16)
        codes = torch.randint(0, K, (N + npad, M), generator=g, device=dev,
                              dtype=torch.uint8)
        if distinct:  # each score shared by ~2,500 docs: ties at tau
            codes[:N] = codes[:distinct].repeat(-(-N // distinct), 1)[:N]
        G, cap = search_plan(N, topk)
        rows = 50 if name == "full" else Q
        what = f"k1_topk_check {name}"
        gmax = adc_group_max(lut, codes, N, G)
        want = plain_in_slices(lambda sl: adc_group_max_reference(
            lut[sl], codes, N, G), Q, rows)
        check(torch.equal(gmax, want), f"{what}: gmax bit for bit")
        tau = torch.topk(gmax, topk, dim=1).values[:, -1].contiguous()
        got = adc_filter(lut, codes, N, tau, cap, gmax)
        want = plain_in_slices(lambda sl: adc_filter_reference(
            lut[sl], codes, N, tau[sl].contiguous(), cap), Q, rows)
        torch.cuda.synchronize()
        same_candidates(got, want, what, lambda r, ids: score_codes_reference(
            lut[r:r + 1], codes[ids])[0])
        count = got[2]
        reruns = adc_topk.reruns
        s, i = adc_topk(lut, codes, N, topk)
        reruns = adc_topk.reruns - reruns
        if name != "full":  # full_scan holds 64 queries at this size
            scores = adc_scores(lut, codes[:N])
            check(torch.equal(s, torch.topk(scores, topk, dim=1).values)
                  and torch.equal(torch.gather(scores, 1, i), s),
                  f"{what}: adc_topk scores bit-equal to K1 + torch.topk")
            del scores
        check(bool((i[:, 1:] > i[:, :-1])[s[:, 1:] == s[:, :-1]].all()),
              f"{what}: ties in id order")
        check(reruns == int(int(count.max()) > cap),
              f"{what}: pass 2 reran exactly when a count passed cap")
        if distinct:
            check(reruns == 1, f"{what}: the ties force a rerun")
        reps, plain_reps = (5, 1) if name == "full" else (10, 3)
        pass1_ms = time_ms(lambda: adc_group_max(lut, codes, N, G), reps=reps)
        pass2_ms = time_ms(lambda: adc_filter(lut, codes, N, tau, cap, gmax),
                           reps=reps)
        plain1_ms = time_ms(lambda: plain_in_slices(
            lambda sl: adc_group_max_reference(lut[sl], codes, N, G), Q, rows),
            reps=plain_reps, warmup=1)
        plain2_ms = time_ms(lambda: plain_in_slices(
            lambda sl: adc_filter_reference(lut[sl], codes, N,
                                            tau[sl].contiguous(), cap),
            Q, rows), reps=plain_reps, warmup=1)
        topk_ms = time_ms(lambda: adc_topk(lut, codes, N, topk), reps=reps)
        b = pass_bounds(gmax, tau, count, N, M, K, topk)
        res = {
            "adc_group_max": dict(ms=pass1_ms, plain_ms=plain1_ms,
                                  bound_ms=b["pass1"][0],
                                  bound_by=b["pass1"][1], max_abs_err=0.0),
            "adc_filter": dict(ms=pass2_ms, plain_ms=plain2_ms,
                               bound_ms=b["pass2"][0], bound_by=b["pass2"][1],
                               max_abs_err=0.0),
        }
        shape = dict(Q=Q, N=N, M=M, K=K, G=G, topk=topk, cap=cap)
        for r in res.values():
            r["shape"] = shape
        results[name] = res
        emit("k1_topk_check", case=name, **shape, pad_rows=npad,
             distinct_rows=distinct or None, passes=res,
             pass2_adds_share=b["pass2_adds_share"], adc_topk_ms=topk_ms,
             adc_topk_bound_ms=b["search"][0],
             adc_topk_bound_by=b["search"][1],
             candidates_mean=float(count.float().mean()),
             candidates_max=int(count.max()), reruns=reruns,
             library_ms=None)
        del lut, codes, gmax, tau, got, want, s, i, count
        torch.cuda.empty_cache()
    return results


def unfused_search(lut, codes, n_valid: int, topk: int, chunk: int):
    """The search CudaADCIndex ran before the two-pass top-k: K1 scores a
    chunk, pads masked to -inf, torch.topk per chunk, one merge. Kept here
    as the yardstick of adc_topk."""
    import torch
    from repconc_tpu_torch.index.cuda_adc import adc_scores

    cand_s, cand_i = [], []
    for base in range(0, n_valid, chunk):
        scores = adc_scores(lut, codes[base:base + chunk])
        scores[:, n_valid - base:] = -torch.inf
        s, i = torch.topk(scores, min(topk, chunk), dim=1, sorted=False)
        cand_s.append(s)
        cand_i.append(i + base)
    s, pos = torch.topk(torch.cat(cand_s, 1), topk, dim=1)
    return s, torch.gather(torch.cat(cand_i, 1), 1, pos)


def library_search(weight, doc_codes, topk: int, chunk: int):
    """The same search from library calls: embedding_bag scores a chunk,
    torch.topk per chunk, one merge."""
    import torch
    import torch.nn.functional as F

    cand_s, cand_i = [], []
    for base in range(0, doc_codes.shape[0], chunk):
        scores = F.embedding_bag(doc_codes[base:base + chunk], weight,
                                 mode="sum")                   # (Nc, Q)
        s, i = torch.topk(scores, min(topk, scores.shape[0]), dim=0,
                          sorted=False)
        cand_s.append(s)
        cand_i.append(i + base)
    s, pos = torch.topk(torch.cat(cand_s, 0), topk, dim=0)
    return s.T, torch.gather(torch.cat(cand_i, 0), 0, pos).T


def phase_full_scan(dev):
    import torch
    from repconc_tpu_torch.index import cuda_adc
    from repconc_tpu_torch.index.adc import build_lut
    from repconc_tpu_torch.index.cuda_adc import (CudaADCIndex, adc_filter,
                                                  adc_group_max, adc_scores,
                                                  adc_topk, search_plan,
                                                  select_topk)

    M, K, D, Q, topk, N = 12, 256, 768, 1200, 1000, MSMARCO_PASSAGES
    g = torch.Generator(device=dev).manual_seed(SEED)
    codes = torch.randint(0, K, (N, M), generator=g, device=dev,
                          dtype=torch.uint8)
    cent = torch.randn((M, K, D // M), generator=g, device=dev)
    queries = torch.randn((Q, D), generator=g, device=dev)
    index = CudaADCIndex(codes, cent, device=dev)
    del codes
    index.search_device(queries[:8], topk)  # first call: cuBLAS, attributes
    torch.cuda.synchronize()
    times = []
    for rep in range(3):
        reset_launches()
        t = time.perf_counter()
        s, i = index.search_device(queries, topk)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if rep == 0:
            launches = launch_counts()
    search_s = statistics.median(times)
    check(launches["adc_group_max"] == 1 and launches["adc_filter"] >= 1
          and launches["adc_scan"] == 0,
          f"full scan through the two passes, not K1 ({launches})")
    check(tuple(s.shape) == (Q, topk) and bool(torch.isfinite(s).all()),
          "full scan: finite (Q, topk) scores")
    check(bool((i >= 0).all()) and bool((i < N).all()),
          "full scan: ids in range")
    check(bool((s[:, :-1] >= s[:, 1:]).all()), "full scan: sorted scores")
    # the returned scores are the plain sums of the returned docs' codes
    lut_bf16 = build_lut(queries, index.centroids).to(torch.bfloat16)
    lut = lut_bf16.float()
    picked = index.codes[i].long()                         # (Q, topk, M)
    resum = torch.zeros_like(s)
    for m in range(M):
        resum += lut[:, m].gather(1, picked[:, :, m])
    err = float((resum - s).abs().max())
    check(err <= ADC_TOL, f"full scan: returned scores re-summed ({err})")
    del picked, resum
    # 64 queries against the chunked path: scores bit-equal, ids equal
    # except among exact ties (adc_topk takes the lower id there)
    nq = 64
    s_u, i_u = unfused_search(lut_bf16[:nq].contiguous(), index.codes, N,
                              topk, index.chunk)
    check(torch.equal(s[:nq], s_u), "full scan: scores bit-equal to the "
          "chunked K1 + torch.topk path")
    differ = i[:nq] != i_u
    tied = (s[:nq] == s[:nq].roll(1, 1)) | (s[:nq] == s[:nq].roll(-1, 1))
    tied |= s[:nq] == s[:nq, -1:]
    above = s[:nq] > s[:nq, -1:]   # every doc above the cut, in both
    big = torch.iinfo(torch.long).max
    check(bool(tied[differ].all()) and torch.equal(
        torch.sort(torch.where(above, i[:nq], big), 1).values,
        torch.sort(torch.where(above, i_u, big), 1).values),
        "full scan: ids equal to the chunked path's except among exact ties")
    # each step of one search, the chunked path, and their library yardsticks
    lut_c = lut_bf16.contiguous()
    G, cap = search_plan(N, topk)

    def passes(groups):
        gmax = adc_group_max(lut_c, index.codes, N, groups)
        tau = torch.topk(gmax, topk, dim=1).values[:, -1].contiguous()
        return gmax, tau, adc_filter(lut_c, index.codes, N, tau, cap, gmax)

    gmax, tau, cand = passes(G)
    count = cand[2]
    steps = {
        "pass1": lambda: adc_group_max(lut_c, index.codes, N, G),
        "threshold": lambda: torch.topk(gmax, topk, dim=1).values[:, -1]
        .contiguous(),
        "threshold_kthvalue": lambda: torch.kthvalue(gmax, G - topk + 1,
                                                     dim=1).values,
        "pass2": lambda: adc_filter(lut_c, index.codes, N, tau, cap, gmax),
        "final_sort": lambda: select_topk(cand[0], cand[1], topk),
        "final_sort_two_sorts": lambda: select_two_sorts(cand[0], cand[1],
                                                         topk),
        "adc_topk": lambda: adc_topk(lut_c, index.codes, N, topk),
    }
    step_ms = {k: time_ms(fn, reps=5) for k, fn in steps.items()}
    sweep, default = {}, cuda_adc.GROUPS_MAX
    try:
        for groups in (8192, 16384, 32768, 65536):
            cuda_adc.GROUPS_MAX = groups
            ms = time_ms(lambda: adc_topk(lut_c, index.codes, N, topk),
                         reps=3, warmup=1)
            c = passes(groups)[2][2]
            sweep[groups] = dict(ms=ms,
                                 candidates_mean=float(c.float().mean()),
                                 candidates_max=int(c.max()))
    finally:
        cuda_adc.GROUPS_MAX = default
    del gmax, cand
    unfused_ms = time_ms(lambda: unfused_search(lut_c, index.codes, N, topk,
                                                index.chunk), reps=3, warmup=1)
    chunk_codes = index.codes[:index.chunk]
    scan_ms = time_ms(lambda: adc_scores(lut_c, chunk_codes))
    scores = adc_scores(lut_c, chunk_codes)
    chunk_topk_ms = time_ms(lambda: torch.topk(scores, topk, dim=1,
                                               sorted=False))
    del scores
    torch.cuda.empty_cache()
    # the same search from library calls: embedding_bag + torch.topk
    weight = lut.reshape(Q, M * K).T.contiguous()          # (M * K, Q)
    doc_codes = (index.codes[:N].long()
                 + torch.arange(M, device=dev) * K)        # (N, M), 849 MB
    library_search_ms = time_ms(lambda: library_search(
        weight, doc_codes, topk, index.chunk), reps=1, warmup=1)
    s_l, _ = library_search(weight, doc_codes, topk, index.chunk)
    library_search_err = float((s_l - s).abs().max())
    emit("full_scan", N=N, M=M, K=K, Q=Q, topk=topk, groups=G,
         cap=cap, codes_mb=index.codes.numel() / 1e6,
         search_s=search_s, search_s_all=times, queries_per_s=Q / search_s,
         launches=launches, step_ms=step_ms,
         candidates_mean=float(count.float().mean()),
         candidates_max=int(count.max()), reruns=launches["adc_topk_reruns"],
         groups_sweep=sweep, rescore_max_abs_err=err,
         chunked_search_ms=unfused_ms,
         chunked_queries_per_s=Q / (unfused_ms / 1e3), chunk=index.chunk,
         chunk_scan_ms=scan_ms, chunk_topk_ms=chunk_topk_ms,
         library_search_ms=library_search_ms,
         library_search_max_abs_err=library_search_err)
    del index, s, i, lut, lut_bf16, lut_c, s_u, i_u, weight, doc_codes, s_l
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, library_search_ms=library_search_ms,
                launches=launches)


class HashTokenizer:
    """Stand-in for a BERT tokenizer, so the smoke run needs no
    `transformers`: lower-cased whitespace words hashed into the vocab between
    [CLS] and [SEP], padded to the longest row (or to max_length with
    padding="max_length", as the training collator asks), with the HF call
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
        width = (max_length if padding == "max_length"
                 else max(len(r) for r in rows))
        return {"input_ids": [r + [self.pad_id] * (width - len(r)) for r in rows],
                "attention_mask": [[1] * len(r) + [0] * (width - len(r))
                                   for r in rows]}


def synthetic_data(n_docs: int = 65_536, n_queries: int = 256,
                   seed: int = SEED):
    """Docs of 16-128 words from a Zipf-like vocabulary; each query is a
    prefix of one doc, which is its only judged-relevant doc."""
    import numpy as np

    rng = np.random.default_rng(seed)
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


def m12_config():
    """The config of the M=12 checkpoint (artifacts/r5h_m12_conc_best.tar):
    bert-base with a 7,905-word vocabulary, mean pooling, METRIC_IP, M=12,
    K=256, sk_epsilon 0.003 and sk_iters 100."""
    from repconc_tpu_torch.core.config import EncoderConfig, RepConcConfig

    return RepConcConfig(
        encoder=EncoderConfig(model_type="bert", vocab_size=7905,
                              hidden_size=768, num_hidden_layers=12,
                              num_attention_heads=12, intermediate_size=3072,
                              max_position_embeddings=512, type_vocab_size=2,
                              pooling="mean"),
        MCQ_M=12, MCQ_K=256, similarity_metric="METRIC_IP")


def phase_main_path(dev):
    import copy

    import numpy as np
    import torch
    from repconc_tpu_torch.core.profiling import Stopwatch
    from repconc_tpu_torch.eval.encode import encode_queries, encode_texts
    from repconc_tpu_torch.eval.pipeline import repconc_retrieval
    from repconc_tpu_torch.eval.run_io import write_run_tsv
    from repconc_tpu_torch.eval.trec import evaluate_run
    from repconc_tpu_torch.index.adc import build_lut, score_codes_reference
    from repconc_tpu_torch.models.repconc_model import RepConcModel, init_random_

    config = m12_config()
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
    check(launches["adc_group_max"] > 0 and launches["adc_filter"] > 0,
          f"main path launched both passes of the K1 top-k ({launches})")
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
    probe_cells, then the exact-grid grouping. Returns (cells, row,
    work_cell, slot_pair)."""
    import torch
    from repconc_tpu_torch.index.cuda_ivf import group_pairs
    from repconc_tpu_torch.index.ivf import probe_cells

    g = torch.Generator(device=dev).manual_seed(seed)
    coarse = torch.randn((nlist, D), generator=g, device=dev)
    q = torch.randn((Q, D), generator=g, device=dev)
    cells = probe_cells(q, coarse, nprobe)
    row, work_cell, slot_pair = group_pairs(cells, Q, nlist, nprobe)
    pairs = torch.arange(Q * nprobe, device=dev)
    check(torch.equal(slot_pair.reshape(-1)[row].long(), pairs)
          and int((slot_pair >= 0).sum()) == Q * nprobe,
          "exact tile grid: every pair in one slot, none dropped")
    return cells, row, work_cell, slot_pair


def phase_ivf_checks(dev):
    """K2, K3 and K4 against their plain versions on the card."""
    import torch
    from repconc_tpu_torch.index.adc import (group_size, quantize_lut_int8,
                                             score_codes_int8_reference)
    from repconc_tpu_torch.index.cuda_adc import adc_scores_int8
    from repconc_tpu_torch.index.cuda_ivf import (QT_G, score_work_tiles,
                                                  score_work_tiles_reference,
                                                  slot_queries)

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
            _, _, work_cell, slot_pair = ivf_geometry(dev, Q, nlist, nprobe,
                                                      16 * M, seed)
            qidx = slot_queries(slot_pair, nprobe, Q)
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
            # what the kernel moves beyond the bound, counted: each occupied
            # slot's LUT staged from L2 once per tile, the codes read from
            # HBM / L2 once per tile and from L1 once per sub-tile
            occupied = int((~empty).sum())
            emit("k2_check" if kname == "ivf_scan_bf16" else "k3_check",
                 case=name, occupied_slots=occupied,
                 lut_staged_mb=occupied * (M * K * b + G * 4) / 1e6,
                 tile_codes_mb=T * Lpad * M / 1e6,
                 score_write_mb=T * QT_G * Lpad * 4 / 1e6,
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


def ivf_pass_bounds(work_cell, slot_pair, cell_len, gmax, tau, count,
                    nprobe: int, Lpad: int, M: int, K: int, lut_bytes: int,
                    G: int, topk: int):
    """Least times of the two passes and of the whole ivf_topk on this
    run's tiles, counting what this data needs: the real docs (the passes
    never score a pad). Pass 1: each probed cell's real codes read once,
    each query's LUT once (+ scales), gmax written; the adds of every
    occupied slot over its cell's real docs. Pass 2: the codes of the
    (cell, run) pairs that some slot re-scans, the LUT, gmax and tau read
    once, the candidates written (12 bytes each) and the counts; the adds of
    each pair's re-scanned runs (gmax >= tau; every run without gmax). The
    search: codes and LUT read once, the top-k written (12 bytes each),
    pass 1's adds."""
    import torch

    dev = work_cell.device
    Q = tau.shape[0]
    P, R = Q * nprobe, -(-Lpad // 32)
    runs_real = (cell_len.long()[:, None]
                 - 32 * torch.arange(R, device=dev)).clamp(0, 32)
    occ = slot_pair >= 0
    pair_cell = torch.zeros(P, dtype=torch.long, device=dev)
    pair_cell[slot_pair[occ].long()] = work_cell.long()[:, None].expand_as(
        slot_pair)[occ]
    pair_runs = runs_real[pair_cell]                          # (P, R)
    probed = torch.zeros(cell_len.shape[0], dtype=torch.bool, device=dev)
    probed[pair_cell] = True
    lut = (Q + 1) * (M * K * lut_bytes + G * 4)
    codes1 = float(runs_real[probed].sum()) * M
    adds1 = float(pair_runs.sum()) * M
    need = (torch.ones((P, R), dtype=torch.bool, device=dev) if gmax is None
            else gmax.reshape(P, R) >= tau.repeat_interleave(nprobe)[:, None])
    adds2 = float((pair_runs * need).sum()) * M
    cell_need = torch.zeros(runs_real.shape, dtype=torch.int32, device=dev)
    cell_need.index_add_(0, pair_cell, need.int())
    codes2 = float((runs_real * (cell_need > 0)).sum()) * M
    gmax_bytes = P * R * 4
    return {
        "pass1": bound_ms(codes1 + lut + gmax_bytes, adds1),
        "pass2": bound_ms(codes2 + lut + gmax_bytes + Q * 4
                          + float(count.sum()) * 12 + Q * 4, adds2),
        "search": bound_ms(codes1 + lut + Q * topk * 12, adds1),
        "pass2_adds_share": adds2 / max(adds1, 1.0),
    }


def same_topk(s, i, s_u, i_u) -> bool:
    """A fused top-k (s, i) against the unfused one (s_u, i_u): scores bit
    for bit; the ids above the cut equal as sets; exact finite ties in id
    order (ivf_topk takes the lower id); -inf only with id -1."""
    import torch

    big = torch.iinfo(torch.long).max
    above = s > s[:, -1:]
    tie = (s[:, 1:] == s[:, :-1]) & torch.isfinite(s[:, 1:])
    return (torch.equal(s, s_u)
            and torch.equal(torch.sort(torch.where(above, i, big), 1).values,
                            torch.sort(torch.where(above, i_u.long(), big),
                                       1).values)
            and bool((i[:, 1:] > i[:, :-1])[tie].all())
            and bool((i[torch.isneginf(s)] == -1).all()))


def select_two_sorts(cand_s, cand_i, topk: int):
    """select_topk's earlier form, kept as its yardstick: a stable sort by
    id, then a stable sort by score (score DESC, id ASC)."""
    import torch

    ids, perm = torch.sort(cand_i, dim=1, stable=True)
    s, perm = torch.sort(torch.gather(cand_s, 1, perm), dim=1,
                         descending=True, stable=True)
    return s[:, :topk], torch.gather(ids, 1, perm[:, :topk])


def unfused_ivf_search(ivf, queries, nprobe: int, topk: int, lut_dtype: str):
    """The IVF search before the passes (the earlier ivf_search_device):
    K2 / K3 score every slot of every tile into a (T, 32, Lpad) buffer,
    regroup_topk gathers each query's rows back and takes the top-k, then
    the spill is merged. Kept here as the yardstick of ivf_topk."""
    from repconc_tpu_torch.index import cuda_ivf
    from repconc_tpu_torch.index.ivf import probe_cells

    Q = queries.shape[0]
    cells = probe_cells(queries, ivf.coarse, nprobe)
    row, work_cell, slot_pair = cuda_ivf.group_pairs(cells, Q, ivf.nlist,
                                                     nprobe)
    lut_z, scales_z = cuda_ivf.make_lut_z(queries, ivf.centroids, lut_dtype)
    scores = cuda_ivf.score_work_tiles(
        work_cell, cuda_ivf.slot_queries(slot_pair, nprobe, Q), lut_z,
        ivf.cell_codes, scales_z)
    s, i = cuda_ivf.regroup_topk(scores.reshape(-1, ivf.cell_codes.shape[1]),
                                 row, cells, ivf.cell_ids, Q, nprobe, topk)
    return cuda_ivf.merge_spill(s, i, ivf.spill, ivf.spill_ids, queries, topk)


def phase_ivf_topk_check(dev):
    """The two passes of the fused IVF top-k (ivf_group_max, ivf_filter),
    bf16 and int8, against their plain versions bit for bit, and ivf_topk
    against K2 / K3 + regroup_topk on the same tiles; times of each."""
    import torch
    from repconc_tpu_torch.index.adc import group_size, quantize_lut_int8
    from repconc_tpu_torch.index.cuda_adc import select_topk
    from repconc_tpu_torch.index.cuda_ivf import (
        cell_lengths, ivf_filter, ivf_filter_reference, ivf_group_max,
        ivf_group_max_reference, ivf_plan, ivf_topk, regroup_topk,
        score_work_tiles, slot_queries)

    K = 256
    cases = [  # name, Q, nlist, nprobe, Lpad, M, topk, full cells, distinct
        ("bench", 1200, 4096, 64, 256, 48, 1000, True, 0),
        ("m12_lpad2048", 1200, 1024, 64, 2048, 12, 1000, False, 0),
        ("ties", 256, 256, 16, 640, 12, 100, False, 3),
        ("tau_neg_inf", 256, 256, 16, 640, 12, 1000, False, 0),
    ]
    results = {}
    for name, Q, nlist, nprobe, Lpad, M, topk, full, distinct in cases:
        seed = SEED + Q + nlist + Lpad + M + distinct
        g = torch.Generator(device=dev).manual_seed(seed)
        cells, row, work_cell, slot_pair = ivf_geometry(dev, Q, nlist, nprobe,
                                                        16 * M, seed)
        qidx = slot_queries(slot_pair, nprobe, Q)
        # cells filled to random lengths (bench.py's IVF has every cell
        # full), consecutive corpus ids, trailing pads
        lens = (torch.full((nlist,), Lpad, device=dev) if full else
                torch.randint(0, Lpad + 1, (nlist,), generator=g, device=dev))
        real = torch.arange(Lpad, device=dev)[None, :] < lens[:, None]
        cell_ids = torch.full((nlist, Lpad), -1, dtype=torch.int32, device=dev)
        cell_ids[real] = torch.arange(int(real.sum()), dtype=torch.int32,
                                      device=dev)
        cell_len = cell_lengths(cell_ids)
        codes = torch.randint(0, K, (nlist, Lpad, M), generator=g, device=dev,
                              dtype=torch.uint8)
        if distinct:  # every cell repeats the same rows: exact ties
            codes[:] = codes[0, :distinct].repeat(-(-Lpad // distinct),
                                                  1)[:Lpad]
        lut = torch.randn((Q, M, K), generator=g, device=dev)
        gm = group_size(M, K)
        lut_i8, scales = quantize_lut_int8(lut, gm)
        zrow = lambda a: torch.cat([a, a.new_zeros((1,) + a.shape[1:])]).contiguous()  # noqa: E731
        variants = {"bf16": (zrow(lut.to(torch.bfloat16)), None, 2, 0),
                    "int8": (zrow(lut_i8), zrow(scales), 1, M // gm)}
        # pass 2 as ivf_topk runs it: tau the topk-th run max and gmax, or,
        # where pass 1 is skipped, tau -inf, no gmax and cap nprobe * Lpad
        pass1, cap = ivf_plan(nprobe, Lpad, topk)
        results[name] = {}
        for lut_dtype, (lut_z, scales_z, b, G) in variants.items():
            what = f"ivf_topk_check {name} {lut_dtype}"
            tiles = (work_cell, slot_pair, lut_z, codes)
            rest = (cell_ids, cell_len, nprobe)
            gmax = ivf_group_max(*tiles, cell_len, nprobe, scales_z)
            want = ivf_group_max_reference(*tiles, cell_len, nprobe, scales_z)
            torch.cuda.synchronize()
            check(torch.equal(gmax, want), f"{what}: gmax bit for bit")
            if pass1:
                tau = torch.topk(gmax.reshape(Q, -1), topk, dim=1).values
                tau, gmax2 = tau[:, -1].contiguous(), gmax
            else:
                tau = torch.full((Q,), -torch.inf, device=dev)
                gmax2 = None
            got = ivf_filter(*tiles, *rest, tau, cap, gmax2, scales_z)
            want = ivf_filter_reference(*tiles, *rest, tau, cap, scales_z)
            torch.cuda.synchronize()
            same_candidates(got, want, what)
            count = got[2]
            reruns = ivf_topk.reruns
            s, i = ivf_topk(*tiles, *rest, topk, scales_z)
            reruns = ivf_topk.reruns - reruns
            scores = score_work_tiles(work_cell, qidx, lut_z, codes, scales_z)
            s_u, i_u = regroup_topk(scores.reshape(-1, Lpad), row, cells,
                                    cell_ids, Q, nprobe, topk)
            check(same_topk(s, i, s_u, i_u), f"{what}: ivf_topk equals K2 / "
                  "K3 + regroup_topk (scores bit for bit, ids but tie order)")
            del scores, s_u, i_u
            check(pass1 == (name != "tau_neg_inf" and name != "bench"),
                  f"{what}: pass 1 runs where k runs can exist")
            if distinct:
                check(reruns == 1, f"{what}: the ties force a rerun")
            kk = min(topk, nprobe * Lpad)
            sel = select_topk(got[0], got[1], kk)
            two = select_two_sorts(got[0], got[1], kk)
            check(torch.equal(sel[0], two[0]) and torch.equal(sel[1], two[1]),
                  f"{what}: select_topk equals the two stable sorts")
            plain_reps = (1, 0) if Lpad > 1000 else (3, 1)
            ms = {
                "select_topk": time_ms(lambda: select_topk(got[0], got[1],
                                                           kk)),
                "select_two_sorts": time_ms(lambda: select_two_sorts(
                    got[0], got[1], kk)),
                "pass1": time_ms(lambda: ivf_group_max(
                    *tiles, cell_len, nprobe, scales_z)),
                "pass2": time_ms(lambda: ivf_filter(
                    *tiles, *rest, tau, cap, gmax2, scales_z)),
                "plain1": time_ms(lambda: ivf_group_max_reference(
                    *tiles, cell_len, nprobe, scales_z), *plain_reps),
                "plain2": time_ms(lambda: ivf_filter_reference(
                    *tiles, *rest, tau, cap, scales_z), *plain_reps),
                "ivf_topk": time_ms(lambda: ivf_topk(*tiles, *rest, topk,
                                                     scales_z)),
                "unfused": time_ms(lambda: regroup_topk(score_work_tiles(
                    work_cell, qidx, lut_z, codes, scales_z).reshape(
                        -1, Lpad), row, cells, cell_ids, Q, nprobe, topk)),
            }
            bd = ivf_pass_bounds(work_cell, slot_pair, cell_len, gmax2, tau,
                                 count, nprobe, Lpad, M, K, b, G, topk)
            shape = dict(Q=Q, nlist=nlist, nprobe=nprobe, Lpad=Lpad, M=M, K=K,
                         T=int(work_cell.shape[0]), topk=topk,
                         real_docs_mean=float(cell_len.float().mean()))
            res = {
                "ivf_group_max": dict(ms=ms["pass1"], plain_ms=ms["plain1"],
                                      bound_ms=bd["pass1"][0],
                                      bound_by=bd["pass1"][1],
                                      max_abs_err=0.0, shape=shape),
                "ivf_filter": dict(ms=ms["pass2"], plain_ms=ms["plain2"],
                                   bound_ms=bd["pass2"][0],
                                   bound_by=bd["pass2"][1], max_abs_err=0.0,
                                   shape=dict(shape, cap=cap,
                                              with_gmax=pass1)),
            }
            results[name][lut_dtype] = res
            emit("ivf_topk_check", case=name, lut_dtype=lut_dtype, **shape,
                 pass1_in_ivf_topk=pass1, cap=cap, passes=res,
                 pass2_adds_share=bd["pass2_adds_share"],
                 candidates_mean=float(count.float().mean()),
                 candidates_max=int(count.max()), reruns=reruns,
                 ivf_topk_ms=ms["ivf_topk"], ivf_topk_bound_ms=bd["search"][0],
                 unfused_k2_regroup_ms=ms["unfused"],
                 select_topk_ms=ms["select_topk"],
                 select_two_sorts_ms=ms["select_two_sorts"], library_ms=None)
            del gmax, gmax2, want, got, tau, count, s, i
        del codes, lut, lut_i8, scales, variants, cell_ids, cell_len
        torch.cuda.empty_cache()
    return results


def launch_counts():
    from repconc_tpu_torch.index.cuda_adc import (adc_filter, adc_group_max,
                                                  adc_scores, adc_scores_int8,
                                                  adc_topk)
    from repconc_tpu_torch.index.cuda_ivf import (ivf_filter, ivf_group_max,
                                                  ivf_topk, score_work_tiles)

    return {"adc_scan": adc_scores.launches,
            "adc_group_max": adc_group_max.launches,
            "adc_filter": adc_filter.launches,
            "adc_topk_reruns": adc_topk.reruns,
            "ivf_scan_bf16": score_work_tiles.launches["bf16"],
            "ivf_scan_i8": score_work_tiles.launches["int8"],
            "ivf_group_max_bf16": ivf_group_max.launches["bf16"],
            "ivf_group_max_i8": ivf_group_max.launches["int8"],
            "ivf_filter_bf16": ivf_filter.launches["bf16"],
            "ivf_filter_i8": ivf_filter.launches["int8"],
            "ivf_topk_reruns": ivf_topk.reruns,
            "adc_scan_i8": adc_scores_int8.launches}


def reset_launches():
    from repconc_tpu_torch.index.cuda_adc import (adc_filter, adc_group_max,
                                                  adc_scores, adc_scores_int8,
                                                  adc_topk)
    from repconc_tpu_torch.index.cuda_ivf import (ivf_filter, ivf_group_max,
                                                  ivf_topk, score_work_tiles)

    adc_scores.launches = 0
    adc_group_max.launches = 0
    adc_filter.launches = 0
    adc_topk.reruns = 0
    adc_scores_int8.launches = 0
    score_work_tiles.launches = {"bf16": 0, "int8": 0}
    ivf_group_max.launches = {"bf16": 0, "int8": 0}
    ivf_filter.launches = {"bf16": 0, "int8": 0}
    ivf_topk.reruns = 0


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
        # the first call at full size grows the caching allocator: timed
        # apart
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
    return out, breakdown


def ivf_breakdown(index, queries, nprobe: int, topk: int):
    """Where one IVF search of the batch spends its time, bf16 and int8:
    each step of CudaIVFIndex.search_device timed alone (CUDA events,
    median of 3), and beside them, as the before, K2 / K3 scoring every
    slot and regroup_topk, and the whole unfused search. The fused top-k is
    held to the unfused one on every query (scores bit for bit, ids except
    tie order); the peak device memory of one whole search of each kind is
    read above what the index holds."""
    import torch
    from repconc_tpu_torch.index import cuda_ivf
    from repconc_tpu_torch.index.cuda_adc import select_topk
    from repconc_tpu_torch.index.ivf import probe_cells

    ivf = cuda_ivf.CudaIVFIndex(index, device=queries.device)
    Q, nlist, Lpad = queries.shape[0], ivf.nlist, ivf.cell_codes.shape[1]
    M, K = ivf.cell_codes.shape[2], ivf.centroids.shape[1]
    cells = probe_cells(queries, ivf.coarse, nprobe)
    row, work_cell, slot_pair = cuda_ivf.group_pairs(cells, Q, nlist, nprobe)
    qidx = cuda_ivf.slot_queries(slot_pair, nprobe, Q)
    pass1, cap = cuda_ivf.ivf_plan(nprobe, Lpad, topk)
    check(pass1, "ivf_scale: pass 1 runs (each query can have k runs)")
    out = {"probe": time_ms(lambda: probe_cells(queries, ivf.coarse, nprobe),
                            reps=3, warmup=1),
           "group_pairs": time_ms(lambda: cuda_ivf.group_pairs(
               cells, Q, nlist, nprobe)),
           "tiles": int(work_cell.shape[0]), "cap": cap,
           "runs_per_cell": -(-Lpad // 32),
           "score_buffer_gb": work_cell.shape[0] * 32 * Lpad * 4 / 1e9}
    for lut_dtype in ("bf16", "int8"):
        lut_z, scales_z = cuda_ivf.make_lut_z(queries, ivf.centroids,
                                              lut_dtype)
        tiles = (work_cell, slot_pair, lut_z, ivf.cell_codes)
        rest = (ivf.cell_ids, ivf.cell_len, nprobe)
        gmax = cuda_ivf.ivf_group_max(*tiles, ivf.cell_len, nprobe, scales_z)
        tau = torch.topk(gmax.reshape(Q, -1), topk, dim=1).values[:, -1]
        tau = tau.contiguous()
        cand = cuda_ivf.ivf_filter(*tiles, *rest, tau, cap, gmax, scales_z)
        reruns = cuda_ivf.ivf_topk.reruns
        s, i = cuda_ivf.ivf_topk(*tiles, *rest, topk, scales_z)
        reruns = cuda_ivf.ivf_topk.reruns - reruns
        scores = cuda_ivf.score_work_tiles(work_cell, qidx, lut_z,
                                           ivf.cell_codes, scales_z)
        flat = scores.reshape(-1, Lpad)
        s_u, i_u = cuda_ivf.regroup_topk(flat, row, cells, ivf.cell_ids, Q,
                                         nprobe, topk)
        check(same_topk(s, i, s_u, i_u), f"ivf_scale {lut_dtype}: the fused "
              f"top-k equals K2 / K3 + regroup_topk on all {Q} queries")
        scan = "k2_scan" if lut_dtype == "bf16" else "k3_scan"
        ms = {  # the before: every score written, then the regroup
            scan: time_ms(lambda: cuda_ivf.score_work_tiles(
                work_cell, qidx, lut_z, ivf.cell_codes, scales_z),
                reps=3, warmup=1),
            "regroup_topk": time_ms(lambda: cuda_ivf.regroup_topk(
                flat, row, cells, ivf.cell_ids, Q, nprobe, topk),
                reps=3, warmup=1)}
        del scores, flat, s_u, i_u
        torch.cuda.empty_cache()
        steps = {
            "lut": lambda: cuda_ivf.make_lut_z(queries, ivf.centroids,
                                               lut_dtype),
            "pass1": lambda: cuda_ivf.ivf_group_max(*tiles, ivf.cell_len,
                                                    nprobe, scales_z),
            "threshold": lambda: torch.topk(gmax.reshape(Q, -1), topk,
                                            dim=1).values[:, -1].contiguous(),
            "pass2": lambda: cuda_ivf.ivf_filter(*tiles, *rest, tau, cap,
                                                 gmax, scales_z),
            "final_sort": lambda: select_topk(cand[0], cand[1], topk),
            "final_sort_two_sorts": lambda: select_two_sorts(cand[0], cand[1],
                                                             topk),
            "ivf_topk": lambda: cuda_ivf.ivf_topk(*tiles, *rest, topk,
                                                  scales_z),
            "spill_topk_merge": lambda: cuda_ivf.merge_spill(
                s, i, ivf.spill, ivf.spill_ids, queries, topk),
            "whole_search": lambda: ivf.search_device(queries, topk, nprobe,
                                                      lut_dtype),
            "whole_search_unfused": lambda: unfused_ivf_search(
                ivf, queries, nprobe, topk, lut_dtype),
        }
        ms.update({name: time_ms(fn, reps=3, warmup=1)
                   for name, fn in steps.items()})
        peak = {}
        for name in ("whole_search", "whole_search_unfused"):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            steps[name]()
            torch.cuda.synchronize()
            peak[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
        b = 2 if lut_dtype == "bf16" else 1
        G = 0 if scales_z is None else scales_z.shape[1]
        bd = ivf_pass_bounds(work_cell, slot_pair, ivf.cell_len, gmax, tau,
                             cand[2], nprobe, Lpad, M, K, b, G, topk)
        out[lut_dtype] = dict(
            step_ms=ms, peak_gb_above_index=peak,
            candidates_mean=float(cand[2].float().mean()),
            candidates_max=int(cand[2].max()), reruns=reruns,
            bound_ms={k: v for k, v in bd.items()},
            k2_bound_ms=ivf_bound(work_cell, qidx, Q + 1, Lpad, M, K, b, G))
        del gmax, tau, cand, s, i, lut_z, scales_z, tiles
        torch.cuda.empty_cache()
    out["spill_steps"] = spill_breakdown(ivf.spill, queries, topk)
    del ivf
    torch.cuda.empty_cache()
    return out


def spill_breakdown(spill, queries, topk: int):
    """The spill's adc_topk step by step (CUDA events, median of 3)."""
    import torch
    from repconc_tpu_torch.index.adc import build_lut
    from repconc_tpu_torch.index.cuda_adc import (adc_filter, adc_group_max,
                                                  adc_topk, search_plan,
                                                  select_topk)

    lut = build_lut(queries, spill.centroids).to(torch.bfloat16).contiguous()
    N = spill.N
    G, cap = search_plan(N, topk)
    gmax = adc_group_max(lut, spill.codes, N, G)
    tau = torch.topk(gmax, topk, dim=1).values[:, -1].contiguous()
    cand = adc_filter(lut, spill.codes, N, tau, cap, gmax)
    steps = {
        "lut": lambda: build_lut(queries, spill.centroids).to(torch.bfloat16),
        "pass1": lambda: adc_group_max(lut, spill.codes, N, G),
        "threshold": lambda: torch.topk(gmax, topk, dim=1).values[:, -1],
        "pass2": lambda: adc_filter(lut, spill.codes, N, tau, cap, gmax),
        "final_sort": lambda: select_topk(cand[0], cand[1], topk),
        "adc_topk": lambda: adc_topk(lut, spill.codes, N, topk),
    }
    out = {name: time_ms(fn, reps=3, warmup=1) for name, fn in steps.items()}
    out.update(N=N, groups=G, cap=cap, candidates_max=int(cand[2].max()))
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
    for name, r in runs.items():
        kind = "i8" if name.endswith("int8") else "bf16"
        n = r["launches"]
        check(n[f"ivf_filter_{kind}"] > 0 and n["ivf_scan_bf16"] == 0
              and n["ivf_scan_i8"] == 0, f"ivf main path {name} went through "
              f"the two passes, not the unfused K2 / K3 ({n})")
    check(full["launches"]["ivf_group_max_bf16"] > 0
          and runs["full_int8"]["launches"]["ivf_group_max_i8"] > 0,
          "ivf main path at full probe launched pass 1 (bf16 and int8)")
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


def write_training_files(root: str, corpus, queries, qrels):
    """The TSVs QDRelDataset reads: corpus, queries and qrels."""
    paths = {k: os.path.join(root, f"{k}.tsv")
             for k in ("corpus", "queries", "qrels")}
    with open(paths["corpus"], "w") as f:
        f.writelines(f"{d}\t{t}\n" for d, t in corpus.items())
    with open(paths["queries"], "w") as f:
        f.writelines(f"{q}\t{t}\n" for q, t in queries.items())
    with open(paths["qrels"], "w") as f:
        f.writelines(f"{q} 0 {d} {r}\n" for q, ds in qrels.items()
                     for d, r in ds.items())
    return paths


def step_split_ms(model, hp, tx, batch, seeds, reps: int = 3):
    """One stage-1 step cut into its parts, each timed with CUDA events
    (median of `reps` steps): the encoder's forward and backward, the
    constrained encode (Sinkhorn), decode + loss (forward and backward) and
    the optimizer. The parts are train/stage1.py::loss_fn's, with the
    encoder's backward run from the gradients of its outputs."""
    import torch
    from repconc_tpu_torch.quant import codebook, losses
    from repconc_tpu_torch.train import stage1

    config = model.config
    parts = {k: [] for k in ("encoder_fwd_bwd", "constrained_encode",
                             "decode_loss", "optimizer", "step")}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        tx.zero_grad()
        ev[0].record()
        enc = {k: stage1.encode_chunked(model, batch[f"{k}_input_ids"],
                                        batch[f"{k}_attention_mask"],
                                        hp.cache_chunk_size, seeds)
               for k in ("query", "pos", "neg")}
        doc = torch.cat([enc["pos"], enc["neg"]], 0)
        ev[1].record()
        codes = codebook.encode(doc, model.centroids, use_constraint=True,
                                sk_epsilon=config.sk_epsilon,
                                sk_iters=config.sk_iters)
        ev[2].record()
        q_leaf = enc["query"].detach().requires_grad_()
        d_leaf = doc.detach().requires_grad_()
        quantized = codebook.decode(codes, model.centroids)
        doc_ids = torch.cat([batch["pos_docids"], batch["neg_docids"]])
        mask = (losses.false_negative_mask(batch["qids"], doc_ids,
                                           batch["query_positives"])
                | losses.duplicate_negative_mask(batch["qids"], doc_ids))
        loss = losses.contrastive_loss(
            q_leaf, losses.straight_through(quantized, d_leaf), mask,
            config.MCQ_M) + hp.mse_loss_weight * losses.mse_loss(quantized,
                                                                 d_leaf)
        loss.backward()
        ev[3].record()
        torch.autograd.backward([enc["query"], doc], [q_leaf.grad, d_leaf.grad])
        ev[4].record()
        tx.step()
        ev[5].record()
        ev[5].synchronize()
        t = [ev[i].elapsed_time(ev[i + 1]) for i in range(5)]
        parts["encoder_fwd_bwd"].append(t[0] + t[3])
        parts["constrained_encode"].append(t[1])
        parts["decode_loss"].append(t[2])
        parts["optimizer"].append(t[4])
        parts["step"].append(ev[0].elapsed_time(ev[5]))
    return {k: statistics.median(v) for k, v in parts.items()}


def phase_train_stage1(dev):
    """Stage-1 training at full width through train/stage1.py::train (the
    card has no `transformers`, so not through the CLI, whose tokenizer
    loader needs it): the M=12 config with seeded weights, the CLI's
    defaults (64 queries, one random negative each, query / doc lengths 16
    / 128, the constraint on, lr 2e-5, centroid lr 5e-4, clip 1.0), 10
    steps, logging every 5, saves every 5 and a validation at step 10 over
    8,192 docs and 256 queries through the flat search (K1's two passes).
    """
    import copy

    import numpy as np
    import torch
    from repconc_tpu_torch.core.checkpoint import load_params, params_to_bytes
    from repconc_tpu_torch.eval.pipeline import evaluate_repconc_model
    from repconc_tpu_torch.models.convert import to_jax_params
    from repconc_tpu_torch.models.repconc_model import RepConcModel, init_random_
    from repconc_tpu_torch.quant import codebook, sinkhorn
    from repconc_tpu_torch.train import stage1
    from repconc_tpu_torch.train.data import (FinetuneCollator, QDRelDataset,
                                              batch_iterator)

    config = m12_config()
    init = init_random_(RepConcModel(config),
                        torch.Generator().manual_seed(SEED + 1), std=0.02)
    tok = HashTokenizer(config.encoder.vocab_size)
    hp = stage1.Stage1Hparams(total_steps=10, logging_steps=5, eval_steps=10,
                              save_steps=5)
    batch_size, max_query_len, max_doc_len = 64, 16, 128
    valid = synthetic_data(n_docs=8192, n_queries=256, seed=SEED + 2)
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_training_files(
            tmp, *synthetic_data(n_docs=8192, n_queries=1024, seed=SEED + 1))
        dataset = QDRelDataset(paths["qrels"], paths["queries"],
                               paths["corpus"], negative="random",
                               negative_per_query=1, sep_token=tok.sep_token)
        collator = FinetuneCollator(tok, max_query_len, max_doc_len)

        def batches(size=batch_size, seed=SEED):
            return batch_iterator(dataset, collator, size, seed=seed)

        out_dir = os.path.join(tmp, "out")
        model = copy.deepcopy(init)
        logs = []
        reset_launches()
        t0 = time.perf_counter()
        out = stage1.train(model, batches(), hp, out_dir, tokenizer=tok,
                           valid_set=valid, log_fn=logs.append, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = launch_counts()
        check(launches["adc_group_max"] > 0 and launches["adc_filter"] > 0,
              f"the validation launched both passes of K1 ({launches})")
        check(out["step"] == hp.total_steps and len(out["history"]) == 2,
              f"trained {out['step']} steps, logged {len(out['history'])}")
        check(all(np.isfinite(h[k]) for h in out["history"]
                  for k in ("loss", "contrastive_loss", "mse_loss",
                            "grad_norm")), "finite losses")
        evals = [m for m in logs if "eval_MRR@10" in m]
        check(len(evals) == 1 and 0.0 <= evals[0]["eval_MRR@10"] <= 1.0,
              "one validation with MRR@10 in [0, 1]")
        saved = load_params(os.path.join(out_dir, "final"))
        check(params_to_bytes(saved) == params_to_bytes(to_jax_params(model)),
              "final/params.msgpack reads back equal to the model (every "
              "key, dtype, shape and value)")
        check(os.path.exists(os.path.join(out_dir, "best", "params.msgpack")),
              "best/ written")
        again = stage1.train(copy.deepcopy(init), batches(), hp, out_dir,
                             tokenizer=tok, valid_set=valid, device=dev)
        check(again["step"] == hp.total_steps and again["history"] == []
              and all(torch.equal(a, b) for a, b in zip(
                  again["model"].state_dict().values(),
                  model.state_dict().values())),
              "a second train call resumes at step 10 and stops at once")
        del again

        # the constrained codes of one step's docs, card against CPU
        b = {k: torch.as_tensor(v).to(dev) for k, v in next(batches()).items()}
        with torch.no_grad():
            docs = torch.cat([
                model.encode_continuous(b[f"{k}_input_ids"],
                                        b[f"{k}_attention_mask"])
                for k in ("pos", "neg")])
        cent = model.centroids.detach()
        on_card = codebook.encode(docs, cent, use_constraint=True).cpu()
        on_cpu = codebook.encode(docs.cpu(), cent.cpu(), use_constraint=True)
        logq = sinkhorn.sinkhorn_log(-sinkhorn.center_distances(
            codebook.pairwise_sqdist(docs.cpu(), cent.cpu())), 0.003, 100)
        top2 = logq.topk(2, dim=-1).values
        tied = (top2[..., 0] - top2[..., 1] < 1e-3).T
        check(bool((on_card[~tied] == on_cpu[~tied]).all())
              and float(tied.float().mean()) < 0.25,
              f"constrained codes card == CPU except near-ties "
              f"({float(tied.float().mean()):.4f} tied)")

        # one step at 8 queries, no dropout, card against CPU. Its 16 docs
        # take argmin codes: against K = 256 centroids the constraint
        # splits each of 16 docs evenly over ~16 centroids, so every
        # constrained argmax is an exact tie that rounding decides (the
        # constrained codes are held above, at the step's 128 docs)
        small = next(batches(8, SEED + 3))
        hp_small = stage1.Stage1Hparams(**dict(hp.__dict__,
                                               use_constraint=False))
        step_out = {}
        for where, m, d in (("cpu", copy.deepcopy(init), "cpu"),
                            ("card", copy.deepcopy(init).to(dev), dev)):
            tx = stage1.make_optimizer(hp_small, m)
            metrics = stage1.make_train_step(m, hp_small, tx)(
                {k: torch.as_tensor(v).to(d) for k, v in small.items()})
            step_out[where] = (
                {k: float(v) for k, v in metrics.items()},
                {n: p.grad.cpu() for n, p in m.named_parameters()},
                {n: v.cpu() for n, v in m.state_dict().items()})
        (m_cpu, g_cpu, p_cpu), (m_card, g_card, p_card) = (
            step_out["cpu"], step_out["card"])
        loss_gap = max(abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
                       for k in m_cpu)
        # The attention key biases' gradient is zero in exact arithmetic
        # (softmax is shift-invariant along a row), and elsewhere a few
        # elements' gradients lie within the gradients' agreement of zero:
        # Adam's first step is lr * g / (|g| + eps), so their steps may
        # differ by up to 2 lr. Every other parameter within 1e-6.
        key = [n for n in g_cpu if n.endswith("key.bias")]
        top = max(float(g.abs().max()) for g in g_cpu.values())
        grad_gap = max(float((g_card[n] - g).abs().max())
                       / max(float(g.abs().max()), 1e-12)
                       for n, g in g_cpu.items() if n not in key)
        key_grad_gap = max(float((g_card[n] - g_cpu[n]).abs().max())
                           for n in key) / top
        param_gap, free_gap, free_moved = 0.0, 0.0, 0
        for n, g in g_cpu.items():
            d = (p_card[n] - p_cpu[n]).abs()
            free = (torch.ones_like(g, dtype=torch.bool) if n in key else
                    g.abs() <= 1e-4 * g.abs().max())
            lr = hp.centroid_learning_rate if n == "centroids" else hp.learning_rate
            d_fixed, d_free = d[~free], d[free]
            if d_fixed.numel():
                param_gap = max(param_gap, float(d_fixed.max()))
            if d_free.numel():
                free_gap = max(free_gap, float(d_free.max()) / lr)
            free_moved += int((d[free] > 1e-6).sum())
        check(loss_gap <= 1e-5 and grad_gap <= 1e-4 and key_grad_gap <= 1e-6
              and param_gap <= 1e-6 and free_gap <= 2.0,
              f"8-query step card == CPU (metrics {loss_gap:.2e} rel, "
              f"gradients {grad_gap:.2e} of each max, key-bias gradients "
              f"{key_grad_gap:.2e} of the largest, parameters "
              f"{param_gap:.2e}; those with a gradient within 1e-4 of its "
              f"array's max of zero, and the key biases, {free_gap:.3f} lr, "
              f"{free_moved} above 1e-6)")
        del step_out

        # timings on the trained model, the full batch, dropout on
        full = {k: torch.as_tensor(v).to(dev) for k, v in next(batches()).items()}
        seeds = torch.Generator().manual_seed(SEED)
        tx = stage1.make_optimizer(hp, model)
        step_fn = stage1.make_train_step(model, hp, tx)
        step_ms = time_ms(lambda: step_fn(full, seeds), reps=5, warmup=1)
        torch.cuda.reset_peak_memory_stats()
        step_fn(full, seeds)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        split = step_split_ms(model, hp, tx, full, seeds)
        docs_sk = torch.randn((2 * batch_size, config.hidden_size),
                              generator=torch.Generator().manual_seed(SEED),
                              ).to(dev)
        sinkhorn_ms = time_ms(lambda: codebook.encode(
            docs_sk, cent, use_constraint=True), reps=5)
        t0 = time.perf_counter()
        eval_m = evaluate_repconc_model(model, tok, *valid, max_seq_length=512,
                                        topk=10, device=dev)
        torch.cuda.synchronize()
        valid_s = time.perf_counter() - t0
    docs = 2 * batch_size
    emit("train_stage1", steps=out["step"], launches=launches,
         train_call_s=train_s, history=out["history"], eval=evals[0],
         step_ms=step_ms, queries_per_s=batch_size / step_ms * 1e3,
         docs_per_s=docs / step_ms * 1e3, step_split_ms=split,
         sinkhorn_ms=sinkhorn_ms,
         sinkhorn_shape={"M": config.MCQ_M, "B": docs, "K": config.MCQ_K,
                         "iters": config.sk_iters},
         peak_memory_gb=peak_gb, validation_s=valid_s,
         validation_mrr_at_10=eval_m["MRR@10"],
         validation_docs=len(valid[0]), validation_queries=len(valid[1]),
         codes_tied_share=float(tied.float().mean()),
         step_card_vs_cpu={"metrics_rel": loss_gap, "grad_rel": grad_gap,
                           "key_bias_grad_rel": key_grad_gap,
                           "param_abs": param_gap,
                           "near_zero_grad_param_lr": free_gap,
                           "near_zero_grad_moved": free_moved})
    print(f"train_stage1 step_ms {step_ms:.3f} queries_per_s "
          f"{batch_size / step_ms * 1e3:.1f} docs_per_s "
          f"{docs / step_ms * 1e3:.1f}", flush=True)
    print("train_stage1 split_ms " + " ".join(
        f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    print(f"train_stage1 peak_memory_gb {peak_gb:.3f} validation_s "
          f"{valid_s:.3f} sinkhorn_ms {sinkhorn_ms:.3f}", flush=True)
    print(card_line(), flush=True)
    return dict(launches=launches)


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
    ("adc_group_max", "repconc_tpu_torch/csrc/adc_scan.cu",
     "repconc_tpu/index/pallas_adc.py:89",
     "_adc_onehot_kernel and the chunk loop of _search_device "
     "(pallas_adc.py:229-260): pass 1"),
    ("adc_filter", "repconc_tpu_torch/csrc/adc_scan.cu",
     "repconc_tpu/index/pallas_adc.py:89",
     "_adc_onehot_kernel and the chunk loop of _search_device "
     "(pallas_adc.py:229-260): pass 2"),
    ("ivf_scan_bf16", "repconc_tpu_torch/csrc/ivf_scan.cu",
     "repconc_tpu/index/pallas_ivf.py:90",
     "_ivf_kernel via _score_work_tiles"),
    ("ivf_scan_i8", "repconc_tpu_torch/csrc/ivf_scan.cu",
     "repconc_tpu/index/pallas_ivf.py:112",
     "_ivf_kernel_i8 via _score_work_tiles"),
    ("adc_scan_i8", "repconc_tpu_torch/csrc/adc_scan_i8.cu",
     "repconc_tpu/index/pallas_adc.py:107",
     "_adc_onehot_kernel_i8 via adc_scores_pallas_int8"),
    ("ivf_group_max_bf16", "repconc_tpu_torch/csrc/ivf_scan.cu",
     "repconc_tpu/index/pallas_ivf.py:90",
     "_ivf_kernel via _score_work_tiles, and _regroup_topk "
     "(pallas_ivf.py:314-336): pass 1"),
    ("ivf_filter_bf16", "repconc_tpu_torch/csrc/ivf_scan.cu",
     "repconc_tpu/index/pallas_ivf.py:90",
     "_ivf_kernel via _score_work_tiles, and _regroup_topk "
     "(pallas_ivf.py:314-336): pass 2"),
    ("ivf_group_max_i8", "repconc_tpu_torch/csrc/ivf_scan.cu",
     "repconc_tpu/index/pallas_ivf.py:112",
     "_ivf_kernel_i8 via _score_work_tiles, and _regroup_topk: pass 1"),
    ("ivf_filter_i8", "repconc_tpu_torch/csrc/ivf_scan.cu",
     "repconc_tpu/index/pallas_ivf.py:112",
     "_ivf_kernel_i8 via _score_work_tiles, and _regroup_topk: pass 2"),
]
NO_LIBRARY = {  # why a kernel has no one-call PyTorch yardstick
    "adc_group_max": "no single PyTorch call takes group maxima of ADC "
                     "scores (embedding_bag, then scatter_reduce)",
    "adc_filter": "no single PyTorch call keeps the docs above a threshold "
                  "(embedding_bag, a comparison, nonzero)",
    "ivf_scan_bf16": "no single PyTorch call gathers per-tile LUTs",
    "ivf_scan_i8": "no single PyTorch call gathers per-tile LUTs with "
                   "per-group scales",
    "adc_scan_i8": "no single PyTorch call sums int8 LUT entries per group "
                   "and scales the groups",
    "ivf_group_max_bf16": "no single PyTorch call takes run maxima of "
                          "cell-grouped ADC scores",
    "ivf_filter_bf16": "no single PyTorch call keeps the docs of probed "
                       "cells above a per-query threshold",
    "ivf_group_max_i8": "as ivf_group_max_bf16, with per-group scales",
    "ivf_filter_i8": "as ivf_filter_bf16, with per-group scales",
}


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
    topk_checks = phase_k1_topk_check(dev)
    checks = phase_ivf_checks(dev)
    ivf_topk_checks = phase_ivf_topk_check(dev)
    full_scan = phase_full_scan(dev)
    ivf_scale, ivf_breakdown_ms = phase_ivf_scale(dev)
    main_path = phase_main_path(dev)
    ivf_runs = phase_ivf_main_path(dev, main_path)
    train_run = phase_train_stage1(dev)

    # launches on the paths: both passes of the K1 top-k on the flat main
    # path (phase 4); both passes of the IVF top-k on the IVF path, with
    # K2's scan body for the bf16 LUT and K3's for the int8 LUT (phase 7).
    # K1's score-returning scan, K2 / K3 writing every score, and K4 are on
    # no path: the passes took the place of the first two, and K4 has none
    # in the JAX package either. Their launches there must stay 0; k1_check,
    # k2_check, k3_check and k4_check hold them against their plain versions
    on_paths = [main_path["launches"], *ivf_runs.values(),
                *(r["launches"] for r in ivf_scale.values())]
    launches = {
        "adc_scan": (sum(r["adc_scan"] for r in on_paths), None),
        "adc_group_max": (main_path["launches"]["adc_group_max"],
                          "main_path"),
        "adc_filter": (main_path["launches"]["adc_filter"], "main_path"),
        "ivf_scan_bf16": (sum(r["ivf_scan_bf16"] for r in on_paths), None),
        "ivf_scan_i8": (sum(r["ivf_scan_i8"] for r in on_paths), None),
        "adc_scan_i8": (sum(r["adc_scan_i8"] for r in on_paths), None),
    }
    for kind, run in (("bf16", "full_bf16"), ("i8", "full_int8")):
        for p in ("ivf_group_max", "ivf_filter"):
            launches[f"{p}_{kind}"] = (ivf_runs[run][f"{p}_{kind}"],
                                       f"ivf_main_path {run}")
    timed = {
        "adc_scan": dict(k1[(1200, 1 << 17, 12)], max_abs_err=worst,
                         shape={"Q": 1200, "N": 1 << 17, "M": 12, "K": 256}),
        "adc_group_max": topk_checks["full"]["adc_group_max"],
        "adc_filter": topk_checks["full"]["adc_filter"],
        "ivf_scan_bf16": checks["ivf_scan_bf16"]["bench"],
        "ivf_scan_i8": checks["ivf_scan_i8"]["bench"],
        "adc_scan_i8": checks["adc_scan_i8"][(1200, 1 << 17, 12)],
    }
    for name in ("ivf_scan_bf16", "ivf_scan_i8", "adc_scan_i8"):
        timed[name] = dict(timed[name], max_abs_err=max(
            r["max_abs_err"] for r in checks[name].values()))
    # the IVF passes at the M=12 check shape (with their plain versions),
    # and at ivf_scale's serving shape (CUDA events, no plain version there)
    for lut, kind in (("bf16", "bf16"), ("int8", "i8")):
        at_scale = ivf_breakdown_ms[lut]
        for p, step in (("ivf_group_max", "pass1"), ("ivf_filter", "pass2")):
            timed[f"{p}_{kind}"] = dict(
                ivf_topk_checks["m12_lpad2048"][lut][p],
                ivf_scale_ms=at_scale["step_ms"][step],
                ivf_scale_bound_ms=at_scale["bound_ms"][step][0],
                ivf_scale_bound_by=at_scale["bound_ms"][step][1])
    elsewhere = {  # launches of the passes outside the main path
        "full_scan": {k: full_scan["launches"][k]
                      for k in ("adc_group_max", "adc_filter")},
        "ivf_scale": {lut: {k: r["launches"][k]
                            for k in ("adc_group_max", "adc_filter")}
                      for lut, r in ivf_scale.items()},
        "ivf_main_path": {name: {k: r[k] for k in ("adc_group_max",
                                                   "adc_filter")}
                          for name, r in ivf_runs.items()},
        "train_stage1": {k: train_run["launches"][k]
                         for k in ("adc_group_max", "adc_filter")},
    }
    check(all(v > 0 for v in elsewhere["full_scan"].values())
          and all(v > 0 for r in elsewhere["ivf_scale"].values()
                  for v in r.values()),
          f"full_scan and the ivf_scale spill ran both passes ({elsewhere})")
    check(all(r["launches"][f"ivf_{p}_{k}"] > 0
              for lut, r in ivf_scale.items()
              for p, k in (("group_max", "bf16" if lut == "bf16" else "i8"),
                           ("filter", "bf16" if lut == "bf16" else "i8"))),
          "ivf_scale's searches ran both IVF passes")
    line = []
    for name, source, replaces, function in KERNELS:
        n, path = launches[name]
        if path is None:
            check(n == 0, f"{name}, on no path, was not launched on one")
        else:
            check(n > 0, f"{name} launched on its path ({path})")
        t = timed[name]
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "replaces_function": function,
                 "launches": n, "launches_in": path,
                 "on_path": path is not None,
                 "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                 "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": t["bound_by"],
                 "library_ms": t.get("library_ms"), "shape": t["shape"]}
        if name in NO_LIBRARY:
            entry["library_null_because"] = NO_LIBRARY[name]
        else:
            entry["library_call"] = t["library_call"]
            entry["library_max_abs_err"] = t["library_max_abs_err"]
        if name in ("adc_group_max", "adc_filter"):
            entry["launches_elsewhere"] = {
                k: v for k, v in elsewhere.items()}
        for k in ("ivf_scale_ms", "ivf_scale_bound_ms", "ivf_scale_bound_by"):
            if k in t:
                entry[k] = t[k]
        line.append(entry)
    print(json.dumps({"kernels": line}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
