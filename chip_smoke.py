#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (repconc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --tf32-samples N

The second form measures how far apart TRAINED_FP32_BARS hold the card's
fp32 and TF32 stage-2 steps: after the builds, dense_front, then for each
of two stage-1 starts train_stage1 and train_stage2 with N more 8-query
batches (one tf32_samples line each start), and nothing else.

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
                counts, at M=4, 8, 12, 16, 24, 48, 96 (Q=129, N=100,003,
                pad docs present), with exact ties at tau (a forced rerun of pass
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
                scored; the corpus encoded again from a TokenCache built
                with the hash tokenizer: the cache hit, the codes equal
                the online encode's bit for bit; docs/s and the tokenize /
                device_encode split of both encodes; the port's WordPiece
                tokenizer over a 7,905-word vocabulary of the same words:
                tokenize-only docs/s with and without its per-word memo,
                and a third, online encode with it: docs/s and split
  4b heldout_m12
                the held-out search on the real M=12 model: its codes of
                the regenerated 200,000-doc corpus and its 241 dev query
                embeddings (repconc_tpu_torch/fixtures/heldout_m12/)
                through batch_adc_search (K1's two passes, bf16 LUT),
                top-1000; scores equal to the plain bf16-LUT top-1000 bit
                for bit, ids but for the order of exact ties; MRR@10
                printed beside the committed CPU fp32-LUT run's (and the
                count of queries whose metrics differ) and the TPU run's
                0.63838
  4c heldout_m12_opq
                the same for the held-out OPQ leg: the warm-up model's
                codes of the same corpus and its 241 rotated dev query
                embeddings (repconc_tpu_torch/fixtures/heldout_m12_opq/),
                MRR@10 beside the CPU run's and the TPU run's 0.49315
  5 k2_check, k3_check, k4_check
                K2 / K3 (cell-grouped IVF scan writing every score, bf16 /
                int8 LUT) against their plain versions, at the IVF bench
                geometry (M=48, nlist=4096, Lpad=256, Q=1200, nprobe=64,
                pairs from a real probe), an M=12 layout with Lpad=2048,
                Lpad=640 and a single occupied slot: scores to
                rtol=atol=1e-5; kernel, plain and bound times, and the LUT
                bytes each tile re-stages. K4 (int8 brute-force scan)
                bit-equal to its plain version at (Q, N, M) = (1200,
                131,072, 12), (129, 100,003, 48), (1, 1000, 12), (37, 5003,
                12), all-+127 and all--127 LUTs at M=48, K=32 with codes up
                to 255, and N=1537; kernel, plain, bound and embedding_bag
                times
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
  6b ivf_balanced
                build_ivf(balanced=True) (Sinkhorn-constrained coarse
                k-means) over ivf_scale's codes at nlist 4096: Lpad, spill
                and build s beside the unbalanced build's; 1200 queries at
                nprobe=64, top-1000, through the two IVF passes, held as
                ivf_scale holds its searches (re-sums, probed cells, the
                exact top-1000 of 64 queries), and the search's breakdown
  7 ivf_main_path
                the CLI's own IVF branch (run_repconc_eval.search_ivf) on
                phase 4's codes and query embeddings, nlist=64, through the
                two IVF passes (K2 / K3 unfused: 0 launches): at full probe
                the ranking equals the flat ranking except near-ties; the
                int8 LUT run and nprobe=8 recall; every run's scores
                re-summed as in phase 6; TREC run written and scored
  7a ivf_decoded
                decoded residency: on ivf_main_path's index, the bf16 and
                int8 stores' searches on the card held to the same torch
                ops on the CPU (int8 bit-equal, bf16 within 1e-5 of the
                largest score; ids but for ties), the spill merged by K1;
                at MS MARCO's size, the int8 store of ivf_scale's index (or
                the balanced one, whichever fits), timed per 1200-query
                batch beside the ADC search, with its bytes and peak memory
  7a' run_ivf_sweep
                the sweep CLI through its main() on ivf_main_path's codes,
                queries and codebook (nlist 64, nprobes 8-64, top-100,
                bf16 and int8 LUTs): recall never falls, and reaches 0.99
                (bf16) or 0.9 (int8) at full probe
  7a'' bf16_main_path
                main_path's model with bf16 activations: 128 docs on the
                card and on the CPU against the CPU's fp32 embeddings (the
                card's gap at most twice the CPU's), and the 8,192 longest
                docs encoded in fp32 and in bf16 on the card: docs/s
  7b dense_front
                stages 0 and 2-5 of the pipeline chained at the M=12
                checkpoint's encoder widths (768 hidden, 12 layers, vocab
                7905, mean pooling, METRIC_IP) through the functions the
                CLIs call: an HF dir of seeded weights written by
                save_hf_checkpoint and read back bit-equal; stage 0 (the
                run-free validation set, 4 steps of dense training at the
                recipe's values: 256 queries of 16 tokens, one random
                negative, docs of 128 tokens, GradCache chunks of 128, lr
                1e-4; one dense validation, no K1 launch; export_hf equal to
                best/); stage 2 (customize); stage 3 (dense eval of 16,384
                synthetic docs and 256 queries through the resumable cache,
                top-200 against a plain fp64 top-200, 1,024 docs card vs
                CPU within 1e-4); stage 4 (the validation set from the
                run); stage 5 (run_warmup at M=12, K=256, the CLI's
                defaults: the model dir loads, the rotation is orthogonal,
                codes.npy equals the model's own codes of 2,048 docs except
                fp32 near-ties); stage 6 (the warm-up model's top-210 from
                the warm-up index through K1's two passes, then the
                miner); stage-0 step ms and peak memory, encode docs/s,
                warm-up s
  7c dense_scale
                stages 3 and 5 at MS MARCO's size, the encoder bypassed:
                8,841,823 x 768 correlated fp32 embeddings (27.2 GB) made on
                the card; batch_flat_search of 1200 queries at top-200
                (the top-200 of 16 queries against a plain fp64 top-200; ms
                against its bound); warmup_from_embeds at the CLI's
                defaults on the resident corpus (262,144 training points,
                20 x 4 + 25 Lloyd iterations): the rotation orthogonal,
                OPQ's MSE below plain PQ's on the same subsample; OPQ fit
                s, PQ encode s, peak memory; the 27.2 GB freed
  8 train_stage1
                stage-1 training at full width (the M=12 config, from
                dense_front's warm-up model dir as stage 7 starts, the
                CLI's defaults: 64 queries + 64 positives + 64
                random negatives a step, lengths 16 / 128, the Sinkhorn
                constraint at eps 0.003 and 100 iterations) through
                train/stage1.py::train: 10 steps, saves every 5, one
                validation over 8,192 docs and 256 queries through the flat
                search, where both passes of K1 must launch; finite losses,
                final/params.msgpack read back equal to the model, a second
                train call resumes and stops at once, one step's
                constrained codes card == CPU except near-ties, an 8-query
                step (argmin codes) card == CPU, the same step with bf16
                activations on the card and the CPU against the CPU's fp32
                step (the card's gradient gap at most twice the CPU's);
                the median step time,
                training queries/s
                and docs/s, the step split into encoder, Sinkhorn, decode +
                loss and optimizer (CUDA events), peak memory, validation s
  9 train_stage2
                stage-2 (JPQ) training at full width through
                train/stage2.py::train, from a model dir of train_stage1's
                final weights: 8,841,823 random M=12 codes on the card, 2,048
                queries of 32 tokens, the stage-9 recipe's values (batch 128,
                200 dynamic negatives, lr 5e-6, centroid lr 2e-4, dropout
                on), 10 steps, saves every 5, one validation (256 queries,
                top-10); every step's hard-negative search is K1's two
                passes (adc_group_max and adc_filter at least once a step,
                the unfused K1 never); finite losses, centroids moved, one
                step's ids against a plain top-200 over the same bf16 LUT,
                planted positives masked, final/params.msgpack read back
                equal, a second train call resumes and stops, an 8-query
                step card == CPU at 100,003 codes (from the trained
                weights in fp64 and from seeded weights in fp32; from the
                trained weights in fp32 its ids are held, and each
                card's gaps to the fp64 step at most the CPU's plus fixed
                bars, TRAINED_FP32_BARS: gradients 5e-4 of an array's max,
                parameters 1e-6, loss and grad_norm 1e-4 relative; the
                card's step once more with TF32 on must exceed the CPU's
                gaps by at least 3x the gradient and parameter bars);
                the median step time, queries/s, the step split (encoder, search: LUT, pass 1,
                tau, pass 2, sort; decode + loss; optimizer), peak memory,
                validation s, K1's passes at Q=128, k=200 beside their
                bounds
  9a data_parallel
                data parallelism on the one card: create_mesh() through the
                REPCONC_* env contract at world size 1, a real NCCL group;
                the corpus-sharded K1 search (ShardedCudaADCIndex) over
                full_scan's 8,841,823 codes (1200 queries, top-1000) and
                the cell-sharded IVF (ShardedCudaIVFIndex) over ivf_scale's
                index (nprobe 64, bf16 and int8) equal to CudaADCIndex /
                CudaIVFIndex, scores and ids; run_repconc_eval with and
                without --data_parallel over 8,192 of main_path's docs
                (in-process, the hash tokenizer patched in): the same
                run.tsv; one stage-1 and one stage-2 step from
                train_stage1's weights with mesh= and without, held to the
                step bars (the max gaps printed, expected 0); then the
                W = 2 and 4 partitions in one process (local_mesh), each
                rank's local part merged by merge_topk: scores bit-equal to
                the unsharded searches, ids but for exact ties; the times
                of the sharded search at world 1, the gather and merge,
                and the stage-1 step with mesh=; the group destroyed
  9b pipeline_recipe
                the port's recipe as a user runs it, on the card, with
                `transformers` not importable: make_pipeline_data synth
                (the M=12 model's widths: bert-base, vocab 7,905, mean
                pooling; 2 layers, 40,000 docs), then
                repconc_tpu_torch/recipes/run_pipeline.sh stage by stage,
                2-10 (M=12, K=256; 20 steps each in stages 7 and 9), and
                stage 8 again with IVF=1 (nlist 40, nprobe 32): each
                stage's files and wall time, finite MRR@10 in the dense,
                conc and jpq metric.json; then stage 8 in this process
                (run_repconc_eval.main, flat and IVF) with the launch
                counters: K1's and K2's passes launched, the codes and
                metric.json equal to the recipe's; then
                repconc_tpu_torch/recipes/beir_eval.sh over a BEIR-layout
                copy of the dev split (make_pipeline_data.beir_layout)
                with stage 8's model, length and batch: its metric.json
                equal to stage 8's
  9c stage1_scale
                the reference's production stage-1 step (bert-base, M=48,
                4096 queries x 12 docs, GradCache chunks of 128) in bf16
                through repconc_tpu_torch/recipes/bench_stage1_scale.py:
                1 warm-up step, 1 timed (split into its parts); finite
                losses and gradients; step ms against its
                bf16 bound (the fp32 bound beside it), docs/s, peak memory
  10 kernels    one JSON line per the port's kernel table

The last lines are the kernels line, the card's `nvidia-smi` name and power
limit, and {"ok": true, "device": {...}}. Any failure raises and exits
non-zero. The script writes only to a temporary directory and to the
package's _build/ directory. It imports torch, numpy, the standard library
and repconc_tpu_torch; nothing of JAX.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
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
        ("m4", 129, 100_003, 4, 77, 0),    # 768x, run_matrix.sh's M
        ("m8", 129, 100_003, 8, 77, 0),    # the compression sweep's M
        ("m12", 129, 100_003, 12, 77, 0),
        ("m16", 129, 100_003, 16, 77, 0),
        ("m24", 129, 100_003, 24, 77, 0),
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
        # the plain versions ran once above (the checks): no warm-up here
        plain1_ms = time_ms(lambda: plain_in_slices(
            lambda sl: adc_group_max_reference(lut[sl], codes, N, G), Q, rows),
            reps=plain_reps, warmup=0)
        plain2_ms = time_ms(lambda: plain_in_slices(
            lambda sl: adc_filter_reference(lut[sl], codes, N,
                                            tau[sl].contiguous(), cap),
            Q, rows), reps=plain_reps, warmup=0)
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
    """Stand-in for a BERT tokenizer in the phases written before the port
    had its own (it keeps their data as it was; pipeline_recipe and
    main_path's WordPiece encode run the real one): lower-cased whitespace
    words hashed into the vocab between [CLS] and [SEP], padded to the
    longest row (or to max_length with padding="max_length", as the
    training collator asks), with the HF call convention."""

    pad_id, cls_id, sep_id, first_word_id = 0, 101, 102, 1000
    sep_token = "[SEP]"

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def get_vocab(self) -> dict:
        """What a TokenCache's fingerprint reads: the special ids and the
        hashed word slots (without it the fingerprint is the repr, which
        holds the object's address, and no cache would ever be hit)."""
        vocab = {"[PAD]": self.pad_id, "[CLS]": self.cls_id,
                 "[SEP]": self.sep_id}
        vocab.update({f"[crc32 {j}]": j for j in
                      range(self.first_word_id, self.vocab_size)})
        return vocab

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


def synthetic_wordpiece(model_dir: str, vocab_size: int):
    """The port's WordPiece tokenizer over a vocabulary of synthetic_data's
    words, written as HF's BertTokenizerFast saves one: the specials, the
    pieces ##0-##9 and w, then w0, w1, ... up to vocab_size entries, so the
    rarer words split into pieces (w12345 -> w1234 ##5)."""
    from repconc_tpu_torch.models.tokenization import load_tokenizer
    from repconc_tpu_torch.recipes.make_pipeline_data import (SPECIALS,
                                                              tokenizer_files)

    head = SPECIALS + [f"##{d}" for d in range(10)] + ["w"]
    vocab = head + [f"w{j}" for j in range(vocab_size - len(head))]
    os.makedirs(model_dir, exist_ok=True)
    for name, text in tokenizer_files(vocab).items():
        with open(os.path.join(model_dir, name), "w") as f:
            f.write(text)
    return load_tokenizer(model_dir)


def tokenize_docs_per_s(tok, texts, max_len: int, batch: int = 256) -> float:
    """Tokenize-only docs/s of `tok` over `texts` in the encode's batches
    (eval/encode.py::tokenize_batch), in this thread."""
    from repconc_tpu_torch.eval.encode import tokenize_batch

    t0 = time.perf_counter()
    for i in range(0, len(texts), batch):
        tokenize_batch(tok, texts[i:i + batch], max_len, "doc")
    return len(texts) / (time.perf_counter() - t0)


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


@contextlib.contextmanager
def logged(logger):
    """The messages `logger` emits inside the block, at INFO and above."""
    messages = []

    class Keep(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())

    handler, level = Keep(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield messages
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def phase_main_path(dev):
    import copy

    import numpy as np
    import torch
    from repconc_tpu_torch.core.profiling import Stopwatch
    from repconc_tpu_torch.eval import encode as encode_mod
    from repconc_tpu_torch.eval.encode import (TokenCache, encode_corpus,
                                               encode_queries, encode_texts,
                                               tokenize_batch)
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

    # the corpus again from a TokenCache (run_pretokenize's layout) built
    # with the hash tokenizer: the cache is hit and the codes equal the
    # online encode's bit for bit
    with tempfile.TemporaryDirectory() as tc_dir:
        t0 = time.perf_counter()
        TokenCache.build([corpus[c] for c in corpus_ids], tok, max_len, tc_dir)
        cache_build_s = time.perf_counter() - t0
        sw_cache = Stopwatch()
        with logged(encode_mod.logger) as messages:
            t0 = time.perf_counter()
            cached, cached_ids = encode_corpus(
                corpus, model, tok, max_len, batch_size=256, output="code",
                device=dev, stopwatch=sw_cache, token_cache_dir=tc_dir)
            cached_s = time.perf_counter() - t0
    check(any(m.startswith("token cache hit") for m in messages)
          and not any("online" in m for m in messages),
          f"main path's token cache was hit ({messages})")
    check(np.array_equal(cached_ids, corpus_ids) and np.array_equal(cached, codes),
          "codes from the token cache equal the online encode's bit for bit")

    # a quarter of the corpus again online with a real tokenizer, the port's
    # WordPiece over a 7,905-entry vocabulary of these words
    # (models/tokenization.py, pure Python in the producer thread): every
    # 4th doc of the longest-first order (16,384 docs, every length; a
    # quarter of the corpus, to keep the run inside its time):
    # tokenize-only docs/s with the per-word memo (filled as it goes),
    # without it, and the hash tokenizer's; the online encode's docs/s and
    # split
    quarter = corpus_ids[::4]
    ordered = [corpus[c] for c in quarter]
    with tempfile.TemporaryDirectory() as wp_dir:
        wp_tok = synthetic_wordpiece(wp_dir, config.encoder.vocab_size)
    tokenize_rate = {"memo": tokenize_docs_per_s(wp_tok, ordered, max_len)}
    wp_tok.memo_limit = 0
    tokenize_rate["no_memo"] = tokenize_docs_per_s(wp_tok, ordered, max_len)
    wp_tok.memo_limit = 1 << 20
    wp_tok._memo.clear()
    hash_rate = tokenize_docs_per_s(tok, ordered, max_len)
    tokens = {name: float(tokenize_batch(t, ordered[::4], max_len,
                                         "doc")[1].sum(1).mean())
              for name, t in (("wordpiece", wp_tok), ("hash", tok))}
    sw_wp = Stopwatch()
    t0 = time.perf_counter()
    wp_codes, wp_ids = encode_corpus({c: corpus[c] for c in quarter}, model,
                                     wp_tok, max_len, batch_size=256,
                                     output="code", device=dev,
                                     stopwatch=sw_wp)
    wp_s = time.perf_counter() - t0
    check(wp_codes.shape == (len(quarter), codes.shape[1])
          and sorted(wp_ids) == sorted(quarter),
          "the WordPiece encode gives every doc's codes")
    print(f"main_path tokenize_docs_per_s wordpiece memo "
          f"{tokenize_rate['memo']:.1f} no_memo "
          f"{tokenize_rate['no_memo']:.1f} hash {hash_rate:.1f}; online "
          f"encode docs_per_s wordpiece {len(quarter) / wp_s:.1f} (tokenize "
          f"{sw_wp.totals['tokenize']:.2f} s, device_encode "
          f"{sw_wp.totals['device_encode']:.2f} s; mean tokens "
          f"{tokens['wordpiece']:.1f} against the hash tokenizer's "
          f"{tokens['hash']:.1f})", flush=True)

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
         token_cache_build_s=cache_build_s, cached_encode_corpus_s=cached_s,
         cached_docs_per_s=len(corpus) / cached_s,
         cached_tokenize_s=sw_cache.totals["tokenize"],
         cached_device_encode_s=sw_cache.totals["device_encode"],
         encode_queries_s=t["encode_queries"], search_s=t["search"],
         search_queries_per_s=len(queries) / t["search"], mrr_at_10=mrr10,
         recall_at_1000=metrics["recall"]["Recall@1000"],
         card_vs_cpu_max_abs_diff=cpu_gap,
         tf32=torch.backends.cuda.matmul.allow_tf32,
         wordpiece_tokenize_docs_per_s=tokenize_rate,
         hash_tokenize_docs_per_s=hash_rate, mean_tokens=tokens,
         wordpiece_docs=len(quarter), wordpiece_encode_corpus_s=wp_s,
         wordpiece_docs_per_s=len(quarter) / wp_s,
         wordpiece_tokenize_s=sw_wp.totals["tokenize"],
         wordpiece_device_encode_s=sw_wp.totals["device_encode"])
    return dict(launches=launches, codes=codes, corpus_ids=corpus_ids,
                query_ids=query_ids, q_embeds=q_embeds, qrels=qrels,
                centroids=model.centroids.detach().cpu().numpy(), plain=plain,
                cpu_model=cpu_model, texts=[corpus[c] for c in corpus_ids])


def phase_heldout(dev, leg: str = "heldout_m12"):
    """A held-out leg's search on the card: a real M=12 model's codes of
    the regenerated 200,000-doc corpus and its 241 dev queries
    (repconc_tpu_torch/fixtures/<leg>/, cut from the port's CPU eval run:
    heldout_m12 the RepCONC checkpoint, heldout_m12_opq the OPQ warm-up)
    through batch_adc_search, K1's two passes with the bf16 LUT, top-
    1000; held to the plain top-1000 over the same bf16 LUT on the card,
    then scored and set beside the CPU's fp32-LUT run and the TPU's."""
    import numpy as np
    import torch
    from repconc_tpu_torch.fixtures import heldout
    from repconc_tpu_torch.index.adc import build_lut, plain_topk
    from repconc_tpu_torch.index.cuda_adc import CudaADCIndex

    fx = heldout.load(os.path.join(heldout.HERE, leg))
    tpu_mrr10 = heldout.LEGS[leg]["tpu_mrr10"]
    N, M = fx["codes"].shape
    Q, topk = len(fx["qids"]), heldout.TOPK
    index = CudaADCIndex(fx["codes"], fx["centroids"], device=dev)
    reset_launches()
    t0 = time.perf_counter()
    scores, docids = heldout.search(fx, device=dev, searcher=index)
    search_s = time.perf_counter() - t0
    launches = launch_counts()
    check(launches["adc_group_max"] > 0 and launches["adc_filter"] > 0,
          f"{leg} launched both passes of the K1 top-k ({launches})")
    with tempfile.TemporaryDirectory() as tmp:
        metric = heldout.score_run(fx, scores, docids,
                                   os.path.join(tmp, "run.tsv"))
    check(scores.shape == (Q, topk) and bool(np.isfinite(scores).all())
          and len(metric["perquery"]) == Q,
          f"{leg}: 1000 finite scores for each of the 241 queries")

    # the plain top-1000 over the same bf16 LUT, on the card
    codes = torch.as_tensor(fx["codes"], device=dev)
    lut = build_lut(torch.as_tensor(fx["query_embeds"], device=dev),
                    torch.as_tensor(fx["centroids"], device=dev)
                    ).to(torch.bfloat16)
    plain_s, plain_i = plain_topk(lut, codes, N, topk)
    row_of = {d: j for j, d in enumerate(fx["corpus_ids"])}
    got_i = torch.tensor([[row_of[d] for d in r] for r in docids], device=dev)
    check(same_topk(torch.as_tensor(scores, device=dev), got_i, plain_s,
                    plain_i),
          f"{leg}: scores equal the plain bf16-LUT top-1000 bit for bit, "
          "ids but for the order of exact ties")
    q = torch.as_tensor(fx["query_embeds"], device=dev)
    search_ms = time_ms(lambda: index.search_device(q, topk))
    vs_cpu = heldout.compare(metric, fx["metric"])
    emit(leg, N=N, M=M, Q=Q, topk=topk, launches=launches,
         search_s=search_s, search_ms=search_ms,
         mrr_at_10=metric["mrr"]["MRR@10"],
         ndcg_at_10=metric["ndcg"]["NDCG@10"],
         cpu_fp32_mrr_at_10=vs_cpu["reference_mrr_at_10"],
         cpu_fp32_ndcg_at_10=vs_cpu["reference_ndcg_at_10"],
         queries_differ_from_cpu=vs_cpu["queries_differ"],
         mrr10_differ_from_cpu=vs_cpu["mrr10_differ"],
         tpu_mrr_at_10=tpu_mrr10,
         delta_mrr_at_10_vs_tpu=metric["mrr"]["MRR@10"] - tpu_mrr10)
    return dict(launches=launches)


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
    import torch.nn.functional as F
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

    # K4: the four timed shapes, then edge cases: all-+127 and all--127
    # LUTs at gm=8 (a 16-bit lane's extremes), K=32 with codes up to 255
    # (clamped), an N that is no multiple of the kernel's 512-doc chunk
    k4_cases = [(1200, 1 << 17, 12, 256, "randn"), (129, 100_003, 48, 256, "randn"),
                (1, 1000, 12, 256, "randn"), (37, 5003, 12, 256, "randn"),
                (33, 1001, 48, 256, "plus127"), (33, 1001, 48, 256, "minus127"),
                (17, 777, 12, 32, "randn"), (5, 1537, 12, 256, "randn")]
    for case, (Q, N, M, Kc, kind) in enumerate(k4_cases):
        g = torch.Generator(device=dev).manual_seed(SEED + Q + N + M)
        gm = group_size(M, Kc)
        lut_i8, scales = quantize_lut_int8(
            torch.randn((Q, M, Kc), generator=g, device=dev), gm)
        if kind != "randn":
            lut_i8.fill_(127 if kind == "plus127" else -127)
        codes = torch.randint(0, 256, (N, M), generator=g, device=dev,
                              dtype=torch.uint8)
        got = adc_scores_int8(lut_i8, scales, codes)
        want = score_codes_int8_reference(lut_i8, scales, codes)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"K4 bit-equal to its plain version at Q={Q} N={N} M={M} "
              f"K={Kc} {kind} (max abs err {err})")
        if case >= 4:  # an edge case: checked, not timed
            emit("k4_check", shape=dict(Q=Q, N=N, M=M, K=Kc), lut=kind,
                 max_abs_err=err)
            results["adc_scan_i8"][(Q, N, M, kind)] = dict(max_abs_err=err)
            del lut_i8, scales, codes, got, want
            continue
        ms = time_ms(lambda: adc_scores_int8(lut_i8, scales, codes))
        plain_ms = time_ms(lambda: score_codes_int8_reference(
            lut_i8, scales, codes), reps=3, warmup=1)
        G = scales.shape[1]
        b_ms, b_by = bound_ms(N * M + Q * M * K + Q * G * 4 + Q * N * 4,
                              Q * N * M)
        res = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   max_abs_err=err, shape=dict(Q=Q, N=N, M=M, K=K))
        if (Q, N, M) == (1200, 1 << 17, 12):
            # one library call computing the same function up to fp32
            # rounding: the dequantized (M * K, Q) f32 LUT, each entry times
            # its group's scale, summed over each doc's M rows
            weight = (lut_i8.float() * scales.repeat_interleave(gm, 1)[
                :, :, None]).reshape(Q, M * K).T.contiguous()
            bag = codes.long() + torch.arange(M, device=dev) * K
            res["library_ms"] = time_ms(
                lambda: F.embedding_bag(bag, weight, mode="sum"))
            res["library_max_abs_err"] = float(
                (F.embedding_bag(bag, weight, mode="sum").T - got).abs().max())
            res["library_call"] = ("torch.nn.functional.embedding_bag(codes + "
                                   "m * K, lut_i8 * scale (M * K, Q) f32, "
                                   "mode='sum')")
            del weight, bag
        results["adc_scan_i8"][(Q, N, M)] = res
        emit("k4_check", **{"library_ms": None, **res})
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


def hold_ivf_search(index, codes, cent, queries, s, i, nprobe: int,
                    lut_dtype: str, what: str, exact_rows: int = 64) -> float:
    """ivf_scale's checks of one IVF search's top-k (s, i) over `codes`:
    finite sorted scores; (a) each equals the plain re-sum of its doc's
    codes with the search's own LUT (resum_check); (b) each id lies in a
    probed cell of its query or in the spill; (c) for `exact_rows` queries
    (bf16 LUT), the top-k is the exact top-k of their probed cells and the
    spill, except near-ties. Returns (a)'s max abs error."""
    import torch
    from repconc_tpu_torch.index.adc import build_lut, score_codes_reference
    from repconc_tpu_torch.index.ivf import probe_cells

    dev = codes.device
    N, topk = codes.shape[0], s.shape[1]
    check(s.shape == i.shape and s.shape[0] == queries.shape[0]
          and bool(torch.isfinite(s).all()), f"{what}: finite (Q, topk) scores")
    check(bool((s[:, :-1] >= s[:, 1:]).all()), f"{what}: sorted scores")
    spill_ids = torch.as_tensor(index.spill_ids, device=dev).long()
    err = resum_check(queries, cent, codes, s, i, spill_ids, lut_dtype, what)
    cell_ids = torch.as_tensor(index.cell_ids, device=dev).long()
    cell_of = torch.full((N,), -1, dtype=torch.long, device=dev)
    valid = cell_ids >= 0
    cell_of[cell_ids[valid]] = torch.arange(
        index.nlist, device=dev)[:, None].expand_as(cell_ids)[valid]
    in_spill = torch.zeros(N, dtype=torch.bool, device=dev)
    in_spill[spill_ids] = True
    coarse = torch.as_tensor(index.coarse_centroids, device=dev)
    cells = probe_cells(queries, coarse, nprobe)
    probed = (cell_of[i][:, :, None] == cells[:, None, :]).any(-1)
    check(bool((probed | in_spill[i]).all()),
          f"{what} (b): ids in a probed cell or the spill")
    del probed
    if exact_rows:
        nq = exact_rows
        lut = build_lut(queries[:nq], cent).to(torch.bfloat16).contiguous()
        plain = score_codes_reference(lut, codes)   # (nq, N)
        allowed = in_spill[None, :].repeat(nq, 1)
        members = cell_ids[cells[:nq]].reshape(nq, -1)
        rows = torch.arange(nq, device=dev)[:, None].expand_as(members)
        ok = members >= 0
        allowed[rows[ok], members[ok]] = True
        plain = torch.where(allowed, plain, -torch.inf)
        check(topk_agree(s[:nq], i[:nq], plain, ADC_TOL),
              f"{what} (c): top-{topk} of {nq} queries equals the exact "
              f"top-{topk} of their probed cells and the spill, except "
              f"near-ties")
        del plain, allowed, members, rows, ok
    del cell_ids, cell_of, in_spill
    return err


def ivf_scale_inputs(dev):
    """ivf_scale's data: 8,841,823 random M=12 codes, the codebook and
    1200 queries, drawn on the card from one seeded generator."""
    import torch

    M, K, D, Q = 12, 256, 768, 1200
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    codes = torch.randint(0, K, (MSMARCO_PASSAGES, M), generator=g, device=dev,
                          dtype=torch.uint8)
    cent = torch.randn((M, K, D // M), generator=g, device=dev)
    queries = torch.randn((Q, D), generator=g, device=dev)
    return codes, cent, queries


def phase_ivf_scale(dev):
    """IVF-PQ serving at MS MARCO's passage count with the CLI's defaults."""
    import torch
    from repconc_tpu_torch.core.profiling import Stopwatch
    from repconc_tpu_torch.index.ivf import build_ivf_from_codes, serve_search

    M, K, D, Q, topk, nlist, nprobe = 12, 256, 768, 1200, 1000, 4096, 64
    codes, cent, queries = ivf_scale_inputs(dev)
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
    check(all(tuple(v[0].shape) == (Q, topk) for v in searches.values()),
          "ivf: (Q, topk) results")
    errs_a = {lut_dtype: hold_ivf_search(index, codes, cent, queries, s, i,
                                         nprobe, lut_dtype, f"ivf {lut_dtype}",
                                         exact_rows=64 if lut_dtype == "bf16"
                                         else 0)
              for lut_dtype, (s, i, _, _) in searches.items()}
    s, i = searches["bf16"][:2]
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
    del searches, s, i, s8, i8, codes
    torch.cuda.empty_cache()
    return out, breakdown, index


def same_ranking(s_a, i_a, s_b, i_b, tol: float) -> bool:
    """Two top-k results (numpy): scores rank for rank within tol, and a
    doc in one row but not the other only where its score lies within tol
    of that row's last score (a near-tie at the cut; tol 0: an exact
    tie). Pad slots (-inf, id -1) count as equal."""
    import numpy as np

    same = s_a == s_b  # also equal infinities (pad slots)
    if s_a.shape != s_b.shape or not np.all(
            same | (np.abs(s_a - s_b) <= tol)):
        return False
    for r in np.nonzero((i_a != i_b).any(1))[0]:
        a, b = list(i_a[r]), list(i_b[r])
        for d in set(a) ^ set(b):
            s_d = s_a[r, a.index(d)] if d in a else s_b[r, b.index(d)]
            if abs(s_d - s_a[r, -1]) > tol:
                return False
    return True


def phase_ivf_balanced(dev, unbalanced):
    """build_ivf(balanced=True) over ivf_scale's 8,841,823 codes at nlist
    4096: Lpad, spill and build s beside ivf_scale's unbalanced build of
    the same codes; then 1200 queries at nprobe=64, top-1000, through
    ivf_topk (the two IVF passes, bf16 LUT), held as ivf_scale holds its
    searches, and the search's breakdown."""
    import torch
    from repconc_tpu_torch.core.profiling import Stopwatch
    from repconc_tpu_torch.index.ivf import build_ivf_from_codes, serve_search

    Q, topk, nlist, nprobe = 1200, 1000, 4096, 64
    codes, cent, queries = ivf_scale_inputs(dev)
    q_np = queries.cpu().numpy()
    sw = Stopwatch()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    index = build_ivf_from_codes(codes, cent.cpu().numpy(), nlist=nlist,
                                 balanced=True, device=dev, stopwatch=sw)
    build_s = time.perf_counter() - t
    build_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(index.ntotal == MSMARCO_PASSAGES,
          "ivf_balanced: every doc in a cell or the spill")
    emit("ivf_balanced_build", N=MSMARCO_PASSAGES, nlist=nlist,
         Lpad=index.Lpad, spill=len(index.spill_ids), build_s=build_s,
         unbalanced_Lpad=unbalanced.Lpad,
         unbalanced_spill=len(unbalanced.spill_ids))
    times = []
    for _ in range(3):
        reset_launches()
        t = time.perf_counter()
        s, i = serve_search(index, q_np, topk=topk, nprobe=nprobe, device=dev)
        times.append(time.perf_counter() - t)
    launches = launch_counts()
    check(launches["ivf_group_max_bf16"] > 0 and launches["ivf_filter_bf16"] > 0
          and launches["ivf_scan_bf16"] == 0,
          f"ivf_balanced searched through the two IVF passes ({launches})")
    s = torch.as_tensor(s, device=dev)
    i = torch.as_tensor(i, device=dev).long()
    check(tuple(s.shape) == (Q, topk), "ivf_balanced: (Q, topk) results")
    err = hold_ivf_search(index, codes, cent, queries, s, i, nprobe, "bf16",
                          "ivf_balanced")
    breakdown = ivf_breakdown(index, queries, nprobe, topk)
    N = MSMARCO_PASSAGES
    emit("ivf_balanced", N=N, nlist=nlist, nprobe=nprobe, Q=Q, topk=topk,
         Lpad=index.Lpad, spill=len(index.spill_ids),
         spill_share=len(index.spill_ids) / N, build_s=build_s,
         kmeans_s=sw.totals["ivf_kmeans"], assign_s=sw.totals["ivf_assign"],
         fill_s=sw.totals["ivf_fill"], build_peak_memory_gb=build_peak_gb,
         cell_size_max=int(index.cell_sizes.max()),
         unbalanced={"Lpad": unbalanced.Lpad,
                     "spill": len(unbalanced.spill_ids),
                     "spill_share": len(unbalanced.spill_ids) / N},
         first_search_s=times[0], search_s=times[1:],
         queries_per_s=Q / statistics.median(times[1:]), launches=launches,
         rescore_max_abs_err=err, breakdown_ms=breakdown)
    print(f"ivf_balanced Lpad {index.Lpad} spill {len(index.spill_ids)} "
          f"build_s {build_s:.3f} (unbalanced Lpad {unbalanced.Lpad} spill "
          f"{len(unbalanced.spill_ids)}); search_ms "
          f"{breakdown['bf16']['step_ms']['whole_search']:.3f} (spill "
          f"{breakdown['bf16']['step_ms']['spill_topk_merge']:.3f})",
          flush=True)
    del codes, cent, queries, s, i
    torch.cuda.empty_cache()
    return dict(index=index, launches=launches, breakdown=breakdown)


def phase_ivf_decoded(dev, main, main_index, scale_index, balanced_index):
    """Decoded residency. On ivf_main_path's index (phase 4's codes and
    query embeddings, nlist 64): bf16 and int8 stores, each search on the
    card held to the same torch ops on the CPU, int8 bit-equal (exact
    integer sums), bf16 within 1e-5 of the largest score (fp32 sums in
    another order), ids but for ties; the spill merged by K1. At MS MARCO's
    size: the int8 store of ivf_scale's index, or of the balanced one when
    that does not fit (decoded_bytes against the free memory), timed per
    1200-query batch beside the ADC search of the same index, with the
    store's bytes, build s and peak memory."""
    import numpy as np
    import torch
    from repconc_tpu_torch.index.cuda_ivf import QT_G, CudaIVFIndex

    q, topk = main["q_embeds"], 1000
    card = CudaIVFIndex(main_index, device=dev)
    cpu = CudaIVFIndex(main_index, device="cpu")
    held = {}
    reset_launches()
    for serving in ("decoded", "decoded_int8"):
        for nprobe in (64, 8):
            s_c, i_c = card.search(q, topk=topk, nprobe=nprobe,
                                   serving=serving)
            s_p, i_p = cpu.search(q, topk=topk, nprobe=nprobe,
                                  serving=serving)
            tol = 0.0 if serving == "decoded_int8" else 1e-5 * float(
                np.abs(s_p[np.isfinite(s_p)]).max())
            check(same_ranking(s_c, i_c, s_p, i_p, tol),
                  f"ivf_decoded main path {serving} nprobe={nprobe}: card == "
                  f"CPU (scores within {tol}, ids but for ties)")
            held[f"{serving}_nprobe{nprobe}"] = {
                "max_abs_diff": float(np.abs(np.where(
                    s_c == s_p, 0.0, s_c - s_p)).max()), "tol": tol,
                "rows_with_other_ids": int((i_c != i_p).any(1).sum())}
    launches = launch_counts()
    if len(main_index.spill_ids):
        check(launches["adc_group_max"] > 0 and launches["adc_filter"] > 0,
              f"the decoded searches merged the spill with K1 ({launches})")
    store_bytes_main = {d: card.decoded_bytes(d) for d in ("bf16", "int8")}
    del card, cpu

    codes, cent, queries = ivf_scale_inputs(dev)
    del codes
    nprobe, Q = 64, queries.shape[0]
    chosen, searcher = None, None
    for name, idx in (("ivf_scale", scale_index),
                      ("ivf_balanced", balanced_index)):
        idx.set_centroids(cent.cpu().numpy())
        searcher = CudaIVFIndex(idx, device=dev)
        tiles = Q * nprobe // QT_G + idx.nlist  # at most this many
        workspace = (tiles * QT_G * idx.Lpad * 4 * 2
                     + Q * nprobe * idx.Lpad * 16)
        free = torch.cuda.mem_get_info(dev)[0]
        if searcher.decoded_bytes("int8") + workspace < 0.9 * free:
            chosen = name
            break
        del searcher
        torch.cuda.empty_cache()
    check(chosen is not None, "an int8 decoded store fits at MS MARCO's size")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    searcher.decoded_store("int8")
    torch.cuda.synchronize()
    store_s = time.perf_counter() - t
    reset_launches()
    s_d, i_d = searcher.search_device(queries, topk, nprobe,
                                      serving="decoded_int8")
    s_a, i_a = searcher.search_device(queries, topk, nprobe)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    scale_launches = launch_counts()
    check(tuple(s_d.shape) == (Q, topk) and bool(torch.isfinite(s_d).all())
          and bool((s_d[:, :-1] >= s_d[:, 1:]).all()),
          "ivf_decoded at scale: finite sorted (Q, topk) scores")
    check(bool((i_d.sort(1).values[:, 1:] != i_d.sort(1).values[:, :-1])
               .all()), "ivf_decoded at scale: distinct ids per query")
    overlap = topk_overlap(i_d[:, :100], i_a[:, :100])
    check(overlap >= 0.8, f"ivf_decoded at scale: int8 decoded top-100 "
                          f"overlaps the ADC top-100 ({overlap})")
    decoded_ms = time_ms(lambda: searcher.search_device(
        queries, topk, nprobe, serving="decoded_int8"), reps=3, warmup=1)
    adc_ms = time_ms(lambda: searcher.search_device(queries, topk, nprobe),
                     reps=5, warmup=1)
    idx = searcher.host
    emit("ivf_decoded", main_path={"nlist": main_index.nlist,
                                   "Lpad": main_index.Lpad,
                                   "spill": len(main_index.spill_ids),
                                   "queries": len(q), "held": held,
                                   "store_bytes": store_bytes_main,
                                   "launches": launches},
         at_scale={"index": chosen, "N": MSMARCO_PASSAGES, "nlist": idx.nlist,
                   "Lpad": idx.Lpad, "spill": len(idx.spill_ids), "Q": Q,
                   "nprobe": nprobe, "topk": topk,
                   "store_bytes_int8": searcher.decoded_bytes("int8"),
                   "store_bytes_bf16": searcher.decoded_bytes("bf16"),
                   "store_build_s": store_s, "peak_memory_gb": peak_gb,
                   "decoded_int8_ms": decoded_ms, "adc_bf16_ms": adc_ms,
                   "top100_overlap_with_adc": overlap,
                   "launches": scale_launches})
    print(f"ivf_decoded at {chosen} (Lpad {idx.Lpad}): decoded_int8 "
          f"{decoded_ms:.3f} ms, adc {adc_ms:.3f} ms per {Q}-query batch; "
          f"store {searcher.decoded_bytes('int8') / 1e9:.3f} GB, peak "
          f"{peak_gb:.3f} GB", flush=True)
    del searcher, s_d, i_d, s_a, i_a, queries, cent
    torch.cuda.empty_cache()
    return dict(launches=launches, scale_launches=scale_launches)


def phase_ivf_sweep(dev, main):
    """run_ivf_sweep through its main() on ivf_main_path's artifacts
    (phase 4's codes, query embeddings and codebook), nlist 64, nprobes
    8,16,32,64, top-100, --use_pallas with the bf16 and the int8 LUT: the
    exact baseline is K1's two passes, each nprobe K2's or K3's passes and
    K1 for the spill. Recall must not fall as nprobe grows, and at full
    probe (64 of 64 cells) it is at least 0.99 with the bf16 LUT (the
    baseline's own LUT) and 0.9 with the int8 one."""
    import numpy as np
    from repconc_tpu_torch.cli import run_ivf_sweep
    from repconc_tpu_torch.core.checkpoint import save_model

    model = main["cpu_model"]
    D = model.config.hidden_size
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "codes.npy"), main["codes"])
        np.save(os.path.join(tmp, "q.npy"), main["q_embeds"])
        save_model(os.path.join(tmp, "model"), model.config,
                   {"centroids": main["centroids"],
                    "rotation": np.eye(D, dtype=np.float32)})
        for lut in ("bf16", "int8"):
            path = os.path.join(tmp, f"sweep_{lut}.json")
            reset_launches()
            t = time.perf_counter()
            run_ivf_sweep.main([
                "--codes_path", os.path.join(tmp, "codes.npy"),
                "--query_embed_path", os.path.join(tmp, "q.npy"),
                "--model_name_or_path", os.path.join(tmp, "model"),
                "--nlist", "64", "--nprobes", "8,16,32,64", "--topk", "100",
                "--use_pallas", "--lut_dtype", lut, "--out", path,
                "--device", str(dev)])
            wall_s = time.perf_counter() - t
            launches = launch_counts()
            with open(path) as f:
                data = json.load(f)
            recalls = [r["recall_vs_exact@100"] for r in data["results"]]
            kind = "bf16" if lut == "bf16" else "i8"
            check(launches["adc_group_max"] > 0 and launches["adc_filter"] > 0
                  and launches[f"ivf_group_max_{kind}"] > 0
                  and launches[f"ivf_filter_{kind}"] > 0,
                  f"run_ivf_sweep {lut}: K1's passes (baseline) and the IVF "
                  f"passes ran ({launches})")
            check(all(b >= a for a, b in zip(recalls, recalls[1:])),
                  f"run_ivf_sweep {lut}: recall does not fall ({recalls})")
            floor = 0.99 if lut == "bf16" else 0.9
            check(recalls[-1] >= floor, f"run_ivf_sweep {lut}: recall at "
                                        f"full probe {recalls[-1]} >= {floor}")
            out[lut] = dict(sweep=data, wall_s=wall_s, launches=launches)
    emit("run_ivf_sweep", **out)
    return {lut: r["launches"] for lut, r in out.items()}


def phase_bf16_main_path(dev, main):
    """bf16 activations on main_path's model (the M=12 config, seeded
    weights): 128 of its docs, every 512th of the longest-first corpus (so
    every length), encoded in bf16 on the card and on the CPU, each
    against the CPU's fp32 embeddings: the card's bf16 gap is at most
    twice the CPU's. Then its 8,192 longest docs encoded to codes on the
    card in fp32 and in bf16: docs/s of each."""
    import copy
    import dataclasses

    import numpy as np
    import torch
    from repconc_tpu_torch.eval.encode import encode_texts
    from repconc_tpu_torch.models.repconc_model import RepConcModel

    cpu32 = main["cpu_model"]
    config = cpu32.config
    cfg16 = dataclasses.replace(config, encoder=dataclasses.replace(
        config.encoder, dtype="bfloat16"))
    cpu16 = RepConcModel(cfg16)
    cpu16.load_state_dict(cpu32.state_dict())
    tok = HashTokenizer(config.encoder.vocab_size)
    texts, max_len = main["texts"], 128
    sample = texts[::512][:128]
    emb = {}
    for name, m, d in (("cpu32", cpu32, "cpu"), ("cpu16", cpu16, "cpu"),
                       ("card16", copy.deepcopy(cpu16).to(dev), dev)):
        emb[name] = encode_texts(sample, m, tok, max_len, device=d)
    cpu_gap = float(np.abs(emb["cpu16"] - emb["cpu32"]).max())
    card_gap = float(np.abs(emb["card16"] - emb["cpu32"]).max())
    card_cpu16 = float(np.abs(emb["card16"] - emb["cpu16"]).max())
    check(emb["card16"].dtype == np.float32 and 0.0 < cpu_gap
          and card_gap <= 2 * cpu_gap,
          f"bf16 encode: the card's gap to fp32 {card_gap} <= 2 x the CPU's "
          f"{cpu_gap}")
    n = min(8_192, len(texts))
    timed = {}
    for name, m in (("fp32", copy.deepcopy(cpu32).to(dev)),
                    ("bf16", copy.deepcopy(cpu16).to(dev))):
        encode_texts(texts[:512], m, tok, max_len, output="code", device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        codes = encode_texts(texts[:n], m, tok, max_len, output="code",
                             device=dev)
        torch.cuda.synchronize()
        timed[name] = time.perf_counter() - t
        check(codes.shape == (n, config.MCQ_M), f"bf16 encode: {name} codes")
        del m
    torch.cuda.empty_cache()
    emit("bf16_main_path", docs_compared=len(sample),
         cpu_bf16_gap_to_fp32=cpu_gap, card_bf16_gap_to_fp32=card_gap,
         card_bf16_gap_to_cpu_bf16=card_cpu16, ratio=card_gap / cpu_gap,
         timed_docs=n, fp32_s=timed["fp32"], bf16_s=timed["bf16"],
         fp32_docs_per_s=n / timed["fp32"], bf16_docs_per_s=n / timed["bf16"])
    print(f"bf16_main_path docs_per_s fp32 {n / timed['fp32']:.1f} bf16 "
          f"{n / timed['bf16']:.1f}; gap to fp32 card {card_gap:.4g} cpu "
          f"{cpu_gap:.4g}", flush=True)


def phase_stage1_scale(dev):
    """The reference's production stage-1 step in bf16 at full width:
    bert-base, M=48, 4096 queries x (1 positive + 11 negatives) = 49,152
    docs, GradCache chunks of 128, through
    repconc_tpu_torch/recipes/bench_stage1_scale.py (its batch and
    hyperparameters are the JAX bench's): 1 warm-up step, over the JAX
    bench's batch of 128 queries (the same GradCache chunk shapes), and 1
    timed, the split step (depth cut to one timed step and a 128-query
    warm-up, to keep the run inside its time);
    finite losses and gradients of the timed 4096-query step; step ms
    against the bf16 bound, the fp32 bound beside it (not run), docs/s,
    peak memory."""
    import math

    import torch
    from repconc_tpu_torch.recipes.bench_stage1_scale import run

    out = run(steps=1, warmup_batch=128, device=dev)
    model = out.pop("model")
    check(set(out["metrics"]) == {"loss", "contrastive_loss", "mse_loss"}
          and all(math.isfinite(v) for v in out["metrics"].values()),
          f"stage1_scale: finite losses of the 4096-query step "
          f"({out['metrics']})")
    check(all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
              if p.grad is not None), "stage1_scale: finite gradients")
    del model
    torch.cuda.empty_cache()
    emit("stage1_scale", **out)
    print(f"stage1_scale step_ms {out['step_ms']:.1f} (bound "
          f"{out['bound_ms']:.1f} bf16, {out['bound_fp32_ms']:.1f} fp32) "
          f"docs_per_s {out['docs_per_s']:.1f} peak_memory_gb "
          f"{out['peak_memory_gb']:.3f}", flush=True)
    print("stage1_scale split_ms " + " ".join(
        f"{k} {v:.3f}" for k, v in out["split_ms"].items()), flush=True)
    print(card_line(), flush=True)
    return out


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
    out["spill_steps"] = (None if ivf.spill is None else spill_breakdown(
        ivf.spill, queries, min(topk, ivf.spill.N)))
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
    if G is None:  # fewer than k groups: adc_topk runs pass 2 alone
        return dict(adc_topk=time_ms(lambda: adc_topk(lut, spill.codes, N,
                                                      topk), reps=3, warmup=1),
                    N=N, groups=None, cap=cap)
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
    return {k: v["launches"] for k, v in runs.items()}, index


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


def step_gaps(cpu, card, lr: float, centroid_lr: float):
    """One training step on the card against the same step on the CPU,
    each given as (metrics, gradients, parameters after the step) by name.
    The attention key biases' gradient is zero in exact arithmetic
    (softmax is shift-invariant along a row), and a few other elements'
    gradients lie within the gradients' agreement of zero: Adam's first
    step is lr * g / (|g| + eps), so their steps may differ by up to 2 lr.
    Returns the metrics' largest relative gap, each gradient array's gap
    over its own largest |g| (the key biases' over the largest |g| of any
    array), the other parameters' largest gap, and the near-zero-gradient
    elements' and key biases' largest gap in lr and count above 1e-6."""
    import torch

    (m_cpu, g_cpu, p_cpu), (m_card, g_card, p_card) = cpu, card
    key = [n for n in g_cpu if n.endswith("key.bias")]
    top = max(float(g.abs().max()) for g in g_cpu.values())
    out = {
        "metrics_rel_by_key": {k: abs(m_card[k] - m_cpu[k])
                               / max(abs(m_cpu[k]), 1e-12) for k in m_cpu},
        "grad_rel": max(float((g_card[n] - g).abs().max())
                        / max(float(g.abs().max()), 1e-12)
                        for n, g in g_cpu.items() if n not in key),
        "key_bias_grad_rel": max(float((g_card[n] - g_cpu[n]).abs().max())
                                 for n in key) / top,
        "metrics": {k: (m_cpu[k], m_card[k]) for k in m_cpu},
        "param_abs": 0.0, "near_zero_grad_param_lr": 0.0,
        "near_zero_grad_moved": 0}
    out["metrics_rel"] = max(out["metrics_rel_by_key"].values())
    for n, g in g_cpu.items():
        d = (p_card[n] - p_cpu[n]).abs()
        free = (torch.ones_like(g, dtype=torch.bool) if n in key else
                g.abs() <= 1e-4 * g.abs().max())
        step_lr = centroid_lr if n == "centroids" else lr
        if d[~free].numel():
            out["param_abs"] = max(out["param_abs"], float(d[~free].max()))
        if d[free].numel():
            out["near_zero_grad_param_lr"] = max(
                out["near_zero_grad_param_lr"], float(d[free].max()) / step_lr)
        out["near_zero_grad_moved"] += int((d[free] > 1e-6).sum())
    return out


def bf16_step_gaps(seeded, batch, hp, dev):
    """One stage-1 step of `seeded` with bf16 activations on the card and
    on the CPU, each against the CPU's fp32 step of the same weights and
    batch (dropout off): the card's gradient gap (the largest |difference|
    over every array, after the step's clip) is at most twice the CPU's.
    The loss gaps are reported: one scalar, a mean over the batch, whose
    rounding errors partly cancel, so the ratio of two of them is noise
    (PERF.md, section 6).
    The three steps quantize alike: the card's codes are recorded and
    handed to both CPU steps, so that a code at a near-tie cannot flip
    between them and move the step by more than rounding."""
    import copy
    import dataclasses

    import torch
    from repconc_tpu_torch.models.repconc_model import RepConcModel
    from repconc_tpu_torch.quant import codebook
    from repconc_tpu_torch.train import stage1

    config = seeded.config
    m16 = RepConcModel(dataclasses.replace(config, encoder=dataclasses.replace(
        config.encoder, dtype="bfloat16")))
    m16.load_state_dict(seeded.state_dict())
    real, recorded, out = codebook.encode, [], {}

    def record(*args, **kwargs):
        recorded.append(real(*args, **kwargs))
        return recorded[-1]

    try:
        for name, src, d in (("card16", m16, dev), ("cpu16", m16, "cpu"),
                             ("cpu32", seeded, "cpu")):
            m = copy.deepcopy(src).to(d)
            codebook.encode = (record if not recorded else
                               lambda x, *a, **k: recorded[0].to(x.device))
            tx = stage1.make_optimizer(hp, m)
            metrics = stage1.make_train_step(m, hp, tx)(
                {k: torch.as_tensor(v).to(d) for k, v in batch.items()})
            out[name] = (float(metrics["loss"]),
                         {n: p.grad.cpu() for n, p in m.named_parameters()
                          if p.grad is not None})
            del m, tx
    finally:
        codebook.encode = real
    ref_loss, ref_grads = out["cpu32"]

    def gaps(name):
        loss, grads = out[name]
        return abs(loss - ref_loss), max(float((g - ref_grads[n]).abs().max())
                                         for n, g in grads.items())

    (card_loss, card_grad), (cpu_loss, cpu_grad) = gaps("card16"), gaps("cpu16")
    res = {"card_loss_gap": card_loss, "cpu_loss_gap": cpu_loss,
           "card_grad_gap": card_grad, "cpu_grad_gap": cpu_grad,
           "losses": {k: v[0] for k, v in out.items()}}
    check(0.0 < cpu_grad and card_grad <= 2 * cpu_grad,
          f"bf16 8-query step: the card's gap to the fp32 step within twice "
          f"the CPU's ({res})")
    return res


def check_step_gaps(gaps, what: str) -> None:
    """The bars of a card-vs-CPU step: metrics 1e-5 relative, gradients
    1e-4 of each array's max (key biases 1e-6 of the largest), parameters
    1e-6, near-zero-gradient elements and key biases 2 lr."""
    check(gaps["metrics_rel"] <= 1e-5 and gaps["grad_rel"] <= 1e-4
          and gaps["key_bias_grad_rel"] <= 1e-6 and gaps["param_abs"] <= 1e-6
          and gaps["near_zero_grad_param_lr"] <= 2.0,
          f"{what} card == CPU ({gaps})")


# The fixed bars on the trained start's fp32 stage-2 step (step_gaps'
# keys; PERF.md, section 6). Each device's step is compared with the CPU's
# fp64 step, and the card's gap may exceed the CPU's by at most the bar
# (EXCESS_BARS): fp32 rounding alone gave excesses up to 1.32e-4
# (gradients, of an array's max), 1.7e-7 (parameters) and 6.0e-6 (loss,
# grad_norm), while TF32's excess was 1.16e-3 to 6.73e-3 and 9.9e-6 to
# 3.94e-4 on the first two (PRs 14-16; `--tf32-samples 10`: two starts,
# 22 batches), and must stay at least 3x above those two bars in every
# run, or the check could not catch it. The gradient bar, 2.2e-4, lies
# 1.67x over fp32's most and 1.76x under a third of TF32's least. The
# loss and grad_norm are two scalars whose rounding errors partly cancel:
# TF32 moved them 1.05e-4 to 5.31e-4 and fp32 up to 2.12e-5, too close
# for a bar 3x from both, so theirs bounds fp32 rounding only. The
# key-bias and near-zero-gradient terms are held on each device
# (ABSOLUTE_BARS): that gradient is zero in exact arithmetic under any
# precision (fp32 1e-10, TF32 4e-8), and Adam's first step moves a
# near-zero-gradient element by up to 2 lr under any rounding, TF32
# included (1.94-2.0)
TRAINED_FP32_BARS = {"grad_rel": 2.2e-4, "param_abs": 1e-6, "metrics_rel": 1e-4,
                     "key_bias_grad_rel": 1e-6, "near_zero_grad_param_lr": 2.0}
EXCESS_BARS = ("grad_rel", "param_abs", "metrics_rel")
TF32_SEPARATED = ("grad_rel", "param_abs")  # TF32's excess >= 3 bars
ABSOLUTE_BARS = ("key_bias_grad_rel", "near_zero_grad_param_lr")


def phase_train_stage1(dev, warmup_dir: str):
    """Stage-1 training at full width through train/stage1.py::train (the
    CLI runs in pipeline_recipe; this phase keeps the hash tokenizer's
    data): from dense_front's warm-up model dir, as stage 7
    starts (recipes/run_pipeline.sh:153), the M=12 config; the CLI's
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
    from repconc_tpu_torch.models.repconc_model import (
        RepConcModel, from_pretrained, init_random_)
    from repconc_tpu_torch.quant import codebook, sinkhorn
    from repconc_tpu_torch.recipes.bench_stage1_scale import step_split_ms
    from repconc_tpu_torch.train import stage1
    from repconc_tpu_torch.train.data import (FinetuneCollator, QDRelDataset,
                                              batch_iterator)

    init = from_pretrained(warmup_dir, device="cpu")
    config = init.config
    check(config.to_dict() == m12_config().to_dict(),
          "the warm-up model dir holds the M=12 config")
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
        # constrained codes are held above, at the step's 128 docs). The
        # step starts from seeded weights: the warm-up's centroids fit the
        # docs, so an argmin code can sit at an fp32 near-tie and flip
        # between the devices, which moves the loss and the gradients by
        # more than rounding; those codes are held below, equal except at
        # near-ties
        small = next(batches(8, SEED + 3))
        hp_small = stage1.Stage1Hparams(**dict(hp.__dict__,
                                               use_constraint=False))
        seeded = init_random_(RepConcModel(config),
                              torch.Generator().manual_seed(SEED + 1),
                              std=0.02)
        warm_codes = {}
        for where, m, d in (("cpu", init, "cpu"),
                            ("card", copy.deepcopy(init).to(dev), dev)):
            with torch.no_grad():
                docs16 = torch.cat([m.encode_continuous(
                    torch.as_tensor(small[f"{k}_input_ids"]).to(d),
                    torch.as_tensor(small[f"{k}_attention_mask"]).to(d))
                    for k in ("pos", "neg")])
            warm_codes[where] = (codebook.encode(docs16, m.centroids.detach(),
                                                 use_constraint=False).cpu(),
                                 docs16.cpu().double())
        flips = torch.nonzero(warm_codes["cpu"][0] != warm_codes["card"][0])
        cent64 = init.centroids.detach().double()
        flip_gap = 0.0
        for r, m in flips.tolist():
            sub = warm_codes["cpu"][1][r, m * config.dsub:(m + 1) * config.dsub]
            a = cent64[m, int(warm_codes["cpu"][0][r, m])]
            b = cent64[m, int(warm_codes["card"][0][r, m])]
            scale = float((sub * sub).sum() + torch.maximum((a * a).sum(),
                                                            (b * b).sum()))
            flip_gap = max(flip_gap, abs(float(((sub - a) ** 2).sum()
                                               - ((sub - b) ** 2).sum()))
                           / scale)
        check(flip_gap <= 1e-5, f"the warm-up model's argmin codes of the "
                                f"step's 16 docs, card == CPU except fp32 "
                                f"near-ties ({len(flips)} differ, {flip_gap})")
        step_out = {}
        for where, m, d in (("cpu", copy.deepcopy(seeded), "cpu"),
                            ("card", copy.deepcopy(seeded).to(dev), dev)):
            tx = stage1.make_optimizer(hp_small, m)
            metrics = stage1.make_train_step(m, hp_small, tx)(
                {k: torch.as_tensor(v).to(d) for k, v in small.items()})
            step_out[where] = (
                {k: float(v) for k, v in metrics.items()},
                {n: p.grad.cpu() for n, p in m.named_parameters()},
                {n: v.cpu() for n, v in m.state_dict().items()})
        gaps = step_gaps(step_out["cpu"], step_out["card"], hp.learning_rate,
                         hp.centroid_learning_rate)
        check_step_gaps(gaps, "8-query step")
        bf16_gaps = bf16_step_gaps(seeded, small, hp_small, dev)
        del step_out, seeded

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
        split = step_split_ms(model, hp, tx, full, seeds, reps=3)[0]
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
         step_card_vs_cpu=gaps, warmup_argmin_flips=len(flips),
         warmup_argmin_flip_gap=flip_gap, bf16_step=bf16_gaps)
    print(f"train_stage1 step_ms {step_ms:.3f} queries_per_s "
          f"{batch_size / step_ms * 1e3:.1f} docs_per_s "
          f"{docs / step_ms * 1e3:.1f}", flush=True)
    print("train_stage1 split_ms " + " ".join(
        f"{k} {v:.3f}" for k, v in split.items()), flush=True)
    print(f"train_stage1 peak_memory_gb {peak_gb:.3f} validation_s "
          f"{valid_s:.3f} sinkhorn_ms {sinkhorn_ms:.3f}", flush=True)
    print(card_line(), flush=True)
    return dict(launches=launches, model=model)


def write_query_files(root: str, n_queries: int, n_docs: int, words: int,
                      seed: int):
    """The TSVs QueryDataset reads: n_queries queries of `words` random
    words, each judged relevant to 1-3 random docs among the corpus
    offsets 0..n_docs-1 (whose ids are the offsets as strings)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    paths = {k: os.path.join(root, f"{k}.tsv") for k in ("queries", "qrels")}
    with open(paths["queries"], "w") as f:
        f.writelines(f"q{j}\t" + " ".join(
            f"w{w}" for w in rng.integers(0, 20_000, words)) + "\n"
            for j in range(n_queries))
    with open(paths["qrels"], "w") as f:
        f.writelines(f"q{j} 0 {d} 1\n" for j in range(n_queries)
                     for d in rng.choice(n_docs, int(rng.integers(1, 4)),
                                         replace=False))
    return paths


def stage2_split_ms(model, hp, tx, batch, codes, n_docs: int, seeds,
                    reps: int = 3):
    """One stage-2 step cut into its parts, each timed with CUDA events
    (median of `reps` steps): the query encoder's forward and backward, the
    in-step search (the LUT, pass 1, the threshold tau, pass 2 with its
    count read and any rerun, the final sort), decode + loss (forward and
    backward) and the optimizer. The parts are train/stage2.py::loss_fn's
    and index/cuda_adc.py::adc_topk's, with the encoder's backward run from
    the gradient of its output."""
    import torch
    from repconc_tpu_torch.index.adc import build_lut
    from repconc_tpu_torch.index.cuda_adc import (adc_filter, adc_group_max,
                                                  search_plan, select_topk)
    from repconc_tpu_torch.train import stage1, stage2

    k = hp.dynamic_topk_negative
    G, cap = search_plan(n_docs, k)
    names = ("encoder_fwd", "lut", "pass1", "tau", "pass2", "sort",
             "decode_loss", "encoder_bwd", "optimizer")
    parts = {n: [] for n in names}
    parts["step"], candidates = [], []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(10)]
        tx.zero_grad()
        ev[0].record()
        q = stage1.encode_chunked(model, batch["query_input_ids"],
                                  batch["query_attention_mask"], -1, seeds)
        ev[1].record()
        with torch.no_grad():
            lut = build_lut(q.detach(), model.centroids.detach()).to(
                torch.bfloat16).contiguous()
            ev[2].record()
            gmax = adc_group_max(lut, codes, n_docs, G)
            ev[3].record()
            tau = torch.topk(gmax, k, dim=1).values[:, -1].contiguous()
            ev[4].record()
            cand_s, cand_i, count = adc_filter(lut, codes, n_docs, tau, cap,
                                               gmax)
            most = int(count.max())
            if most > cap:
                cand_s, cand_i, count = adc_filter(lut, codes, n_docs, tau,
                                                   most, gmax)
            ev[5].record()
            neg_pids = select_topk(cand_s, cand_i, k)[1]
        ev[6].record()
        q_leaf = q.detach().requires_grad_()
        loss, _ = stage2.ranking_loss(q_leaf, model.centroids, codes,
                                      neg_pids, batch, hp.temperature)
        loss.backward()
        ev[7].record()
        torch.autograd.backward([q], [q_leaf.grad])
        ev[8].record()
        tx.step()
        ev[9].record()
        ev[9].synchronize()
        for j, n in enumerate(names):
            parts[n].append(ev[j].elapsed_time(ev[j + 1]))
        parts["step"].append(ev[0].elapsed_time(ev[9]))
        candidates.append(float(count.float().mean()))
    out = {n: statistics.median(v) for n, v in parts.items()}
    out["encoder_fwd_bwd"] = out.pop("encoder_fwd") + out.pop("encoder_bwd")
    out["search"] = sum(out[n] for n in ("lut", "pass1", "tau", "pass2",
                                         "sort"))
    return out, statistics.median(candidates)


def phase_train_stage2(dev, stage1_model, tf32_samples: int = 0):
    """Stage-2 (JPQ) training at full width through train/stage2.py::train
    (the CLI runs in pipeline_recipe): the M=12 config from
    the weights train_stage1 ended with, saved as a model dir and read back
    with from_pretrained; 8,841,823 random M=12 codes on the card; 2,048
    queries of 32 tokens with 1-3 judged docs each; the stage-9 recipe's
    values (recipes/run_pipeline.sh:185-202: batch 128, 200 dynamic
    negatives, lr 5e-6, centroid lr 2e-4, temperature 1, clip 1, dropout
    on); 10 steps, logging and saves every 5, one validation at step 10
    (256 queries over the same codes, top-10). Every step's hard-negative
    search is K1's two passes. `tf32_samples`: so many more 8-query
    batches from the trained start, each giving the card's fp32 and TF32
    excesses that TRAINED_FP32_BARS must tell apart (emitted as
    tf32_samples before the phase's checks on them)."""
    import numpy as np
    import torch
    from repconc_tpu_torch.core.checkpoint import load_params, params_to_bytes
    from repconc_tpu_torch.core.config import METRIC_CENTROID_COS
    from repconc_tpu_torch.index.adc import (build_lut, plain_topk,
                                             score_codes_reference)
    from repconc_tpu_torch.index.cuda_adc import (adc_filter, adc_group_max,
                                                  adc_topk, search_plan)
    from repconc_tpu_torch.models import repconc_model
    from repconc_tpu_torch.models.convert import to_jax_params
    from repconc_tpu_torch.quant import codebook
    from repconc_tpu_torch.train import stage1, stage2
    from repconc_tpu_torch.train.data import (QueryCollator, QueryDataset,
                                              batch_iterator)

    t_phase = time.perf_counter()
    N, M, K, steps = MSMARCO_PASSAGES, 12, 256, 10
    batch_size, max_query_len = 128, 32
    hp = stage2.Stage2Hparams(total_steps=steps, logging_steps=5,
                              eval_steps=steps, save_steps=5)
    k = hp.dynamic_topk_negative
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    codes = torch.randint(0, K, (N, M), generator=g, device=dev,
                          dtype=torch.uint8)
    corpus_ids = np.arange(N, dtype=np.int64)
    tok = HashTokenizer(stage1_model.config.encoder.vocab_size)
    valid_rng = np.random.default_rng(SEED + 6)
    valid_q = {f"v{j}": " ".join(f"w{w}" for w in valid_rng.integers(
        0, 20_000, 8)) for j in range(256)}
    valid = (corpus_ids, valid_q,
             {q: {str(int(valid_rng.integers(N))): 1} for q in valid_q})
    with tempfile.TemporaryDirectory() as tmp:
        init_dir = os.path.join(tmp, "stage1_final")
        repconc_model.save_pretrained(init_dir, stage1_model)
        del stage1_model
        torch.cuda.empty_cache()
        model = repconc_model.from_pretrained(init_dir, device=dev)
        config = model.config
        cent0 = model.centroids.detach().clone()
        t0 = time.perf_counter()
        paths = write_query_files(tmp, 2048, N, max_query_len - 2, SEED + 7)
        dataset = QueryDataset(paths["qrels"], paths["queries"], corpus_ids)
        collator = QueryCollator(tok, max_query_len)
        dataset_s = time.perf_counter() - t0

        def batches(size=batch_size, seed=SEED):
            return batch_iterator(dataset, collator, size, seed=seed)

        out_dir = os.path.join(tmp, "out")
        logs = []
        log = lambda d: logs.append((time.perf_counter(), d))  # noqa: E731
        reset_launches()
        t0 = time.perf_counter()
        out = stage2.train(model, codes, batches(), hp, out_dir,
                           tokenizer=tok, valid_set=valid, log_fn=log,
                           device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = launch_counts()
        check(out["step"] == steps and len(out["history"]) == 2,
              f"trained {out['step']} steps, logged {len(out['history'])}")
        check(all(np.isfinite(h[key]) for h in out["history"]
                  for key in ("loss", "grad_norm")), "finite losses")
        check(not torch.equal(model.centroids.detach(), cent0),
              "the centroids changed")
        if config.similarity_metric == METRIC_CENTROID_COS:
            norms = model.centroids.detach().norm(dim=-1)
            check(bool(((norms - 1).abs() < 1e-5).all()),
                  "unit-norm centroids")
        check(launches["adc_group_max"] >= steps + 1
              and launches["adc_filter"] >= steps + 1
              and launches["adc_scan"] == 0,
              f"every step and the validation ran both passes of K1, and "
              f"the unfused K1 none ({launches})")
        evals = [(t, m) for t, m in logs if "eval_MRR@10" in m]
        check(len(evals) == 1 and 0.0 <= evals[0][1]["eval_MRR@10"] <= 1.0,
              "one validation with MRR@10 in [0, 1]")
        # the validation ran between the step-10 log and its own log
        step10 = [t for t, m in logs if m.get("step") == steps
                  and "loss" in m]
        valid_s = evals[0][0] - step10[0]
        saved = load_params(os.path.join(out_dir, "final"))
        check(params_to_bytes(saved) == params_to_bytes(to_jax_params(model)),
              "final/params.msgpack reads back equal to the model")
        again = stage2.train(repconc_model.from_pretrained(init_dir, device=dev),
                             codes, batches(), hp, out_dir, tokenizer=tok,
                             valid_set=valid, device=dev)
        check(again["step"] == steps and again["history"] == []
              and all(torch.equal(a, b) for a, b in zip(
                  again["model"].state_dict().values(),
                  model.state_dict().values())),
              "a second train call resumes at step 10 and stops at once")
        del again
        torch.cuda.empty_cache()

        # one step's search and mask on the trained model (no dropout, so
        # two calls search alike): the ids against a plain top-200 over the
        # same bf16 LUT; positives planted among the ids are masked
        b = {key: torch.as_tensor(v).to(dev) for key, v in
             next(batches(seed=SEED + 8)).items()}
        _, _, aux = stage2.loss_fn(model, hp, b, codes, N, True)
        ids = aux["neg_pids"]
        b["query_positives"][:, 1] = ids[:, 5].int()
        b["query_positives"][::2, 2] = ids[::2, 150].int()
        loss, _, aux = stage2.loss_fn(model, hp, b, codes, N, True)
        check(torch.equal(aux["neg_pids"], ids) and bool(torch.isfinite(loss)),
              "the search repeats on the same inputs; finite loss")
        lut = build_lut(aux["q_embeds"], model.centroids.detach()).to(
            torch.bfloat16).contiguous()
        s, i = adc_topk(lut, codes, N, k)
        s_ref, i_ref = plain_topk(lut, codes, N, k, chunk_size=1 << 20)
        check(torch.equal(i, ids) and same_topk(s, i, s_ref, i_ref),
              "the step's ids equal a plain top-200 (score_codes_reference "
              "by chunk, torch.topk): scores bit-equal, ids but tie order")
        overlap = sum(len(set(r) & {p for p in pos if p >= 0}) for r, pos in
                      zip(ids.tolist(), b["query_positives"].tolist()))
        masked = int(aux["masked"].sum())
        check(masked == overlap and overlap >= batch_size,
              f"masked {masked} retrieved positives, the overlap is "
              f"{overlap}")

        # K1's passes at this shape, with their bounds
        G, cap = search_plan(N, k)
        gmax = adc_group_max(lut, codes, N, G)
        tau = torch.topk(gmax, k, dim=1).values[:, -1].contiguous()
        count = adc_filter(lut, codes, N, tau, cap, gmax)[2]
        pass_ms = {
            "pass1": time_ms(lambda: adc_group_max(lut, codes, N, G)),
            "pass2": time_ms(lambda: adc_filter(lut, codes, N, tau, cap,
                                                gmax)),
            "search": time_ms(lambda: adc_topk(lut, codes, N, k)),
        }
        bounds = pass_bounds(gmax, tau, count, N, M, K, k)
        del gmax, s, i, s_ref, i_ref

        # an 8-query step, card (the kernel) against CPU (the passes' plain
        # versions) at N = 100,003, no dropout: from the trained weights in
        # fp32 and in fp64, and from seeded weights (as train_stage1's
        # step) in fp32. Each run's ids are held equal except near-ties.
        # The trained start's fp64 step and the seeded start's fp32 step
        # are held to the step bars. The trained start's fp32 step is held
        # against the CPU's fp64 step instead of against the other device:
        # its softmax over the negatives is spread (top weight 0.04-0.46
        # against about 1 from seeded weights) over logits up to about 440,
        # so fp32 rounding alone puts each device up to 1.67e-4 of a
        # gradient's max from the exact step, while in fp64 the two devices
        # agree within 1e-12 (PERF.md, section 6). The card's fp32 gaps to
        # the fp64 step may exceed the CPU's by fixed bars
        # (TRAINED_FP32_BARS), set between fp32 rounding and what TF32
        # gives on the same start: the card's step is run once more with
        # TF32 on, and its gradient and parameter excesses must be at least
        # 3x their bars, or the bars could not catch TF32 and the phase
        # fails
        n_small = 100_003

        def small_batch(seed):
            out = next(batches(8, seed))
            out["pos_docids"] %= n_small  # judged docs among the first n_small
            pos = out["query_positives"]
            out["query_positives"] = np.where(pos >= 0, pos % n_small, pos)
            return out

        small = small_batch(SEED + 9)
        seeded_dir = os.path.join(tmp, "seeded")
        repconc_model.save_pretrained(seeded_dir, repconc_model.init_random_(
            repconc_model.RepConcModel(config),
            torch.Generator().manual_seed(SEED + 4), std=0.02))

        def small_step(start_dir, dtype, d, use, tf32=False, batch=small):
            """(metrics, gradients, parameters after the step, the step's
            negatives, query embeddings, starting centroids) of the 8-query
            step on `d`; with tf32, TF32 on for the step (after the model
            load, which turns it off) and restored after it."""
            m = repconc_model.from_pretrained(start_dir, device=d).to(dtype)
            c_start = m.centroids.detach().cpu().clone()
            cc = codes[:n_small].to(d)
            hp_small = stage2.Stage2Hparams(**dict(hp.__dict__,
                                                   use_pallas_search=use))
            bb = {key: torch.as_tensor(v).to(d) for key, v in batch.items()}
            flags = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
            if tf32:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
            try:
                _, _, a = stage2.loss_fn(m, hp_small, bb, cc, n_small,
                                         stage2.takes_kernel(use, d))
                tx = stage1.make_optimizer(hp_small.as_stage1(), m)
                metrics = stage2.make_train_step(m, hp_small, tx, cc)(bb)
                check(not tf32 or torch.backends.cuda.matmul.allow_tf32,
                      "TF32 stayed on through the TF32 step")
            finally:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = flags
            return ({key: float(v) for key, v in metrics.items()},
                    {n: p.grad.cpu() for n, p in m.named_parameters()},
                    {n: v.cpu() for n, v in m.state_dict().items()},
                    a["neg_pids"].cpu(), a["q_embeds"].cpu(), c_start)

        small_gaps, ids_differ, near, steps_by, softmax = {}, {}, {}, {}, {}
        for start, start_dir, dtype in (
                ("trained", init_dir, torch.float32),
                ("trained_fp64", init_dir, torch.float64),
                ("seeded", seeded_dir, torch.float32)):
            step_out = {where: small_step(start_dir, dtype, d, use)
                        for where, d, use in (("cpu", "cpu", True),
                                              ("card", dev, None))}
            (*_, i_cpu, q_cpu, c0), (*_, i_card, q_card, _) = (
                step_out["cpu"], step_out["card"])
            lut_cpu = build_lut(q_cpu, c0).to(torch.bfloat16)
            lut_card = build_lut(q_card, c0).to(torch.bfloat16)
            scores = score_codes_reference(lut_cpu, codes[:n_small].cpu())
            kth = torch.topk(scores, k, dim=1).values[:, -1:]
            near[start] = M * float(
                (lut_card.float() - lut_cpu.float()).abs().max())
            differ = torch.zeros_like(scores, dtype=torch.bool)
            differ.scatter_(1, i_cpu, True)
            differ ^= torch.zeros_like(differ).scatter_(1, i_card, True)
            ids_differ[start] = int(differ.sum()) // 2
            # the CPU step's softmax over [positive; negatives]: its spread
            # and the logits' size set how far rounding moves the gradient
            dec = lambda i: codebook.decode(codes[:n_small].cpu()[i], c0)  # noqa: E731
            logits = torch.cat([
                (q_cpu * dec(torch.as_tensor(small["pos_docids"]).long())
                 ).sum(-1, keepdim=True),
                torch.einsum("bd,bkd->bk", q_cpu, dec(i_cpu.reshape(-1))
                             .reshape(*i_cpu.shape, -1))], 1) / hp.temperature
            logits[:, 1:][stage2.positive_mask(i_cpu, torch.as_tensor(
                small["query_positives"]))] = -float("inf")
            softmax[start] = {
                "max_abs_logit": float(logits[logits.isfinite()].abs().max()),
                "top_weight": torch.softmax(logits, 1).max(1).values.tolist()}
            check(bool(((scores - kth).abs()[differ]
                        <= near[start] + 1e-6).all()),
                  f"8-query step from {start} weights: ids card == CPU except "
                  f"near-ties ({ids_differ[start]} differ; bar "
                  f"{near[start]:.3g})")
            small_gaps[start] = step_gaps(
                step_out["cpu"][:3], step_out["card"][:3], hp.learning_rate,
                hp.centroid_learning_rate)
            if start.startswith("trained"):
                steps_by[start] = {w: o[:3] for w, o in step_out.items()}
            del step_out, scores, differ
        check_step_gaps(small_gaps["trained_fp64"],
                        "8-query step from trained weights in fp64")
        check_step_gaps(small_gaps["seeded"], "8-query step from seeded weights")
        steps_by["trained"]["card_tf32"] = small_step(
            init_dir, torch.float32, dev, None, tf32=True)[:3]
        exact = steps_by.pop("trained_fp64")["cpu"]
        trained_vs_exact = {
            where: step_gaps(exact, out, hp.learning_rate,
                             hp.centroid_learning_rate)
            for where, out in steps_by.pop("trained").items()}
        del exact
        tf32_gaps = trained_vs_exact.pop("card_tf32")
        bars = TRAINED_FP32_BARS
        # the card's excess over the CPU's gap: what both fp32 steps share
        # (a near-tie that fp64 decides the other way, as in one run of PR
        # 15 where both lay 4.07e-4 from it) cancels
        excess = {key: trained_vs_exact["card"][key] - trained_vs_exact["cpu"][key]
                  for key in EXCESS_BARS}
        tf32_excess = {key: tf32_gaps[key] - trained_vs_exact["cpu"][key]
                       for key in EXCESS_BARS}
        tf32_over_bar = {key: tf32_excess[key] / bars[key]
                         for key in EXCESS_BARS}
        sampled = []
        for j in range(tf32_samples):
            b8 = small_batch(SEED + 100 + j)
            runs = {where: small_step(init_dir, dtype, d, use, tf32=t,
                                      batch=b8)[:3]
                    for where, dtype, d, use, t in (
                        ("exact", torch.float64, "cpu", True, False),
                        ("cpu", torch.float32, "cpu", True, False),
                        ("card", torch.float32, dev, None, False),
                        ("card_tf32", torch.float32, dev, None, True))}
            exact = runs.pop("exact")
            g = {where: step_gaps(exact, o, hp.learning_rate,
                                  hp.centroid_learning_rate)
                 for where, o in runs.items()}
            sampled.append({key: {"cpu": g["cpu"][key],
                                  "card_excess": g["card"][key] - g["cpu"][key],
                                  "tf32_excess": (g["card_tf32"][key]
                                                  - g["cpu"][key])}
                            for key in EXCESS_BARS})
            del runs, exact, g
        if sampled:
            emit("tf32_samples", batch_seed=SEED + 9, excess=excess,
                 tf32_excess=tf32_excess, bars=bars, samples=sampled,
                 card_excess_max={key: max(x[key]["card_excess"]
                                           for x in sampled)
                                  for key in EXCESS_BARS},
                 tf32_excess_min={key: min(x[key]["tf32_excess"]
                                           for x in sampled)
                                  for key in EXCESS_BARS})
        print("train_stage2 trained-start fp32 step against the CPU's fp64 "
              "step: " + " ".join(
                  f"{key} card {trained_vs_exact['card'][key]:.3g} cpu "
                  f"{trained_vs_exact['cpu'][key]:.3g} card_tf32 "
                  f"{tf32_gaps[key]:.3g} bar {bars[key]:.3g}"
                  for key in bars), flush=True)
        check(all(tf32_over_bar[key] >= 3.0 for key in TF32_SEPARATED),
              f"the card's TF32 step lies at least 3x the bars further than "
              f"the CPU's fp32 step from the fp64 step, so the bars can catch "
              f"TF32 ({ {key: (tf32_excess[key], bars[key]) for key in TF32_SEPARATED} })")
        check(all(excess[key] <= bars[key] for key in EXCESS_BARS),
              f"8-query fp32 step from trained weights: the card's gaps to "
              f"the fp64 step exceed the CPU's by at most the fixed bars "
              f"({ {key: (excess[key], bars[key]) for key in EXCESS_BARS} })")
        for where, gaps in trained_vs_exact.items():
            check(all(gaps[key] <= bars[key] for key in ABSOLUTE_BARS),
                  f"8-query fp32 step from trained weights on the {where}: "
                  f"key biases and near-zero-gradient elements within their "
                  f"bars ({ {key: (gaps[key], bars[key]) for key in ABSOLUTE_BARS} })")

        # timings on the trained model, dropout on: whole steps (host
        # clock around each, synchronised), the split, peak memory
        seeds = torch.Generator().manual_seed(SEED)
        tx = stage1.make_optimizer(hp.as_stage1(), model)
        step_fn = stage2.make_train_step(model, hp, tx, codes, N)
        timed = [{key: torch.as_tensor(v).to(dev) for key, v in bt.items()}
                 for _, bt in zip(range(steps), batches(seed=SEED + 10))]
        reruns = adc_topk.reruns
        step_s = []
        for bt in timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_fn(bt, seeds)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
        step_ms = statistics.median(step_s[1:]) * 1e3
        timed_reruns = adc_topk.reruns - reruns
        torch.cuda.reset_peak_memory_stats()
        step_fn(timed[0], seeds)
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        split, candidates = stage2_split_ms(model, hp, tx, timed[0], codes, N,
                                            seeds)
        del timed, tx, step_fn
    phase_s = time.perf_counter() - t_phase
    emit("train_stage2", steps=out["step"], launches=launches,
         train_call_s=train_s, dataset_s=dataset_s, history=out["history"],
         eval=evals[0][1], step_ms=step_ms,
         step_ms_all=[t * 1e3 for t in step_s],
         queries_per_s=batch_size / step_ms * 1e3, step_split_ms=split,
         search_candidates_mean=candidates, search_reruns=timed_reruns,
         peak_memory_gb=peak_gb, validation_s=valid_s,
         validation_queries=len(valid_q), k1_at_step_shape={
             "Q": batch_size, "N": N, "M": M, "topk": k, "groups": G,
             "cap": cap, "ms": pass_ms,
             "bound_ms": {p: bounds[p] for p in ("pass1", "pass2", "search")},
             "candidates_mean": float(count.float().mean())},
         masked_positives=masked,
         step_card_vs_cpu={"n_docs": n_small, "ids_differ": ids_differ,
                           "near_tie_bar": near, **small_gaps,
                           "trained_fp32_vs_cpu_fp64": trained_vs_exact,
                           "trained_tf32_card_vs_cpu_fp64": tf32_gaps,
                           "trained_fp32_bars": TRAINED_FP32_BARS,
                           "trained_fp32_card_excess": excess,
                           "trained_tf32_excess": tf32_excess,
                           "trained_tf32_over_bar": tf32_over_bar,
                           "softmax": softmax},
         phase_s=phase_s)
    print(f"train_stage2 step_ms {step_ms:.3f} queries_per_s "
          f"{batch_size / step_ms * 1e3:.1f} (median of steps 2-{steps})",
          flush=True)
    print("train_stage2 split_ms " + " ".join(
        f"{key} {v:.3f}" for key, v in split.items())
        + f" candidates {candidates:.1f} reruns {timed_reruns}", flush=True)
    print(f"train_stage2 peak_memory_gb {peak_gb:.3f} validation_s "
          f"{valid_s:.3f}", flush=True)
    print(f"train_stage2 k1 Q={batch_size} k={k} N={N} " + " ".join(
        f"{p}_ms {pass_ms[p]:.4f} bound_ms {bounds[p][0]:.4f} ({bounds[p][1]})"
        for p in ("pass1", "pass2", "search")), flush=True)
    print(card_line(), flush=True)
    del model, codes
    torch.cuda.empty_cache()
    return dict(launches=launches, pass_ms=pass_ms, bounds=bounds,
                shape={"Q": batch_size, "N": N, "M": M, "K": K, "topk": k})


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def world1_nccl_mesh():
    """create_mesh() through the REPCONC_* env contract at world size 1: a
    real NCCL process group on the one card, destroyed on exit, the env
    restored."""
    import torch.distributed as dist
    from repconc_tpu_torch.core import distributed
    from repconc_tpu_torch.core.mesh import create_mesh

    env = {distributed.ENV_COORDINATOR: f"127.0.0.1:{free_port()}",
           distributed.ENV_NUM_PROCESSES: "1",
           distributed.ENV_PROCESS_ID: "0"}
    os.environ.update(env)
    try:
        mesh = create_mesh()
        check(mesh.backend == "nccl" and mesh.size == 1 and mesh.rank == 0
              and mesh.group is not None,
              f"world-1 mesh through NCCL ({mesh.backend}, {mesh.size})")
        yield mesh
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)


def hold_merged(what: str, s, i, s0, i0) -> None:
    """A sharded top-k (s, i) against the unsharded one (s0, i0): scores
    bit for bit, the ids above the cut equal as sets, and an id different
    only where its score ties a neighbour's."""
    import torch

    big = torch.iinfo(torch.long).max
    above = s0 > s0[:, -1:]
    tied = (s0 == s0.roll(1, 1)) | (s0 == s0.roll(-1, 1))
    check(torch.equal(s, s0) and bool(tied[i != i0].all())
          and torch.equal(torch.sort(torch.where(above, i, big), 1).values,
                          torch.sort(torch.where(above, i0, big), 1).values),
          f"{what}: scores bit-equal to the unsharded search, ids but for "
          f"exact ties")


def step_result(model, metrics):
    return ({k: float(v) for k, v in metrics.items()},
            {n: (p.grad if p.grad is not None else
                 p.new_zeros(p.shape)).cpu() for n, p in
             model.named_parameters()},
            {n: v.cpu() for n, v in model.state_dict().items()})


def exact_gaps(a, b):
    """The largest |difference| between two step results' metrics,
    gradients and parameters (expected 0 at world size 1)."""
    (m_a, g_a, p_a), (m_b, g_b, p_b) = a, b
    return {"metrics": max(abs(m_a[k] - m_b[k]) for k in m_a),
            "grads": max(float((g_a[n] - g_b[n]).abs().max()) for n in g_a),
            "params": max(float((p_a[n].float() - p_b[n].float()).abs().max())
                          for n in p_a)}


def phase_data_parallel(dev, stage1_model, scale_index):
    """Data parallelism on the one card (torch.distributed, NCCL). At world
    size 1 through a real NCCL group (create_mesh under the env contract):
    the corpus-sharded K1 search over full_scan's 8,841,823 codes (1200
    queries, top-1000), the cell-sharded IVF over ivf_scale's index
    (nprobe 64, bf16 and int8 LUTs), run_repconc_eval --data_parallel over
    8,192 of main_path's docs, one stage-1 and one stage-2 step, each
    against its unsharded counterpart. Then the W = 2 and 4 partitions in
    one process (local_mesh): each rank's local part in turn, merged by
    merge_topk, against the unsharded searches. Times (CUDA events): the
    sharded search at world 1 against the unsharded, the gather and merge,
    a stage-1 step with mesh= against the plain step."""
    import copy
    from unittest import mock

    import numpy as np
    import torch
    from repconc_tpu_torch.cli import run_repconc_eval
    from repconc_tpu_torch.core.mesh import local_mesh
    from repconc_tpu_torch.index.cuda_adc import CudaADCIndex
    from repconc_tpu_torch.index.cuda_ivf import (CudaIVFIndex,
                                                  ShardedCudaIVFIndex)
    from repconc_tpu_torch.models import adapters
    from repconc_tpu_torch.models.repconc_model import (RepConcModel,
                                                        init_random_,
                                                        save_pretrained)
    from repconc_tpu_torch.parallel.sharded import (ShardedCudaADCIndex,
                                                    gather_merge, merge_topk)
    from repconc_tpu_torch.train import stage1, stage2
    from repconc_tpu_torch.train.data import (FinetuneCollator, QDRelDataset,
                                              QueryCollator, QueryDataset,
                                              batch_iterator)

    t_phase = time.perf_counter()
    M, K, D, Q, topk, N = 12, 256, 768, 1200, 1000, MSMARCO_PASSAGES
    out = {"flat": {}, "ivf": {}, "partitions": {}}
    reset_launches()
    with world1_nccl_mesh() as mesh, tempfile.TemporaryDirectory() as tmp:
        out["backend"] = mesh.backend
        # K1 over full_scan's codes: world 1 against CudaADCIndex
        g = torch.Generator(device=dev).manual_seed(SEED)
        codes = torch.randint(0, K, (N, M), generator=g, device=dev,
                              dtype=torch.uint8)
        cent = torch.randn((M, K, D // M), generator=g, device=dev)
        queries = torch.randn((Q, D), generator=g, device=dev)
        flat = CudaADCIndex(codes, cent, device=dev)
        s0, i0 = flat.search_device(queries, topk)
        w1 = ShardedCudaADCIndex(mesh, codes, cent)
        s1, i1 = w1.search_device(queries, topk)
        check(torch.equal(s1, s0) and torch.equal(i1, i0),
              "world-1 corpus-sharded K1 search == CudaADCIndex (scores and "
              "ids)")
        local_s, local_i = w1.local_search(queries, topk)
        out["flat"] = {
            "unsharded_ms": time_ms(lambda: flat.search_device(queries, topk),
                                    reps=5, warmup=1),
            "sharded_w1_ms": time_ms(lambda: w1.search_device(queries, topk),
                                     reps=5, warmup=1),
            "local_ms": time_ms(lambda: w1.local_search(queries, topk),
                                reps=5, warmup=1),
            "gather_merge_ms": time_ms(lambda: gather_merge(
                mesh, local_s, local_i, topk), reps=10)}
        del w1, flat, local_s, local_i
        for W in (2, 4):
            parts = []
            for r in range(W):
                ix = ShardedCudaADCIndex(local_mesh(r, W, dev), codes, cent)
                parts.append(ix.local_search(queries, topk))
                del ix
            s, i = merge_topk(*zip(*parts), topk)
            hold_merged(f"K1 over {N} codes at W={W}", s, i, s0, i0)
            out["partitions"][f"flat_w{W}"] = {
                "ids_equal": bool(torch.equal(i, i0)),
                "n_local": -(-N // W)}
            del parts, s, i
        del codes, cent, queries, s0, i0, s1, i1
        torch.cuda.empty_cache()

        # K2 / K3 over ivf_scale's index: world 1 and W = 2, 4
        _, cent, queries = ivf_scale_inputs(dev)
        base = CudaIVFIndex(scale_index, device=dev)
        w1 = ShardedCudaIVFIndex(mesh, scale_index)
        for lut in ("bf16", "int8"):
            s0, i0 = base.search_device(queries, topk, 64, lut)
            s1, i1 = w1.search_device(queries, topk, 64, lut)
            check(torch.equal(s1, s0) and torch.equal(i1, i0),
                  f"world-1 cell-sharded IVF ({lut}) == CudaIVFIndex")
            out["ivf"][lut] = {
                "unsharded_ms": time_ms(lambda: base.search_device(
                    queries, topk, 64, lut), reps=3, warmup=1),
                "sharded_w1_ms": time_ms(lambda: w1.search_device(
                    queries, topk, 64, lut), reps=3, warmup=1)}
            for W in (2, 4):
                ranks = [ShardedCudaIVFIndex(local_mesh(r, W, dev),
                                             scale_index) for r in range(W)]
                parts = [ix.local_search(queries, topk, 64, lut)
                         for ix in ranks]
                s, i = merge_topk(*zip(*parts), parts[0][0].shape[1])
                s, i = ranks[0].merge_spill(s, i, queries, topk)
                hold_merged(f"IVF ({lut}, nprobe 64) at W={W}", s, i, s0, i0)
                out["partitions"][f"ivf_{lut}_w{W}"] = {
                    "ids_equal": bool(torch.equal(i, i0)),
                    "cells_per_rank": [int(ix.cell_codes.shape[0])
                                       for ix in ranks]}
                del ranks, parts, s, i
        out["ivf"]["spill_share"] = len(scale_index.spill_ids) / N
        del base, w1, cent, queries
        torch.cuda.empty_cache()

        # run_repconc_eval with and without --data_parallel, in-process
        config = m12_config()
        tok = HashTokenizer(config.encoder.vocab_size)
        model_dir = os.path.join(tmp, "model")
        save_pretrained(model_dir, init_random_(
            RepConcModel(config), torch.Generator().manual_seed(SEED),
            std=0.02))
        corpus, qs, qrels = synthetic_data()
        corpus = dict(list(corpus.items())[:8192])
        os.makedirs(os.path.join(tmp, "cli"))
        paths = write_training_files(os.path.join(tmp, "cli"), corpus, qs,
                                     qrels)
        runs, secs = {}, {}
        with mock.patch.object(adapters, "load_adapter_tokenizer",
                               lambda *a, **k: tok):
            for name, extra in (("plain", []), ("dp", ["--data_parallel"])):
                args = ["--model_name_or_path", model_dir,
                        "--corpus_path", paths["corpus"],
                        "--query_path", paths["queries"],
                        "--qrel_path", paths["qrels"],
                        "--out_corpus_dir", os.path.join(tmp, name + "_c"),
                        "--out_query_dir", os.path.join(tmp, name + "_q"),
                        "--max_seq_length", "128", "--topk", "1000",
                        "--device", dev.type] + extra
                t0 = time.perf_counter()
                run_repconc_eval.main(args)
                secs[name] = time.perf_counter() - t0
                with open(os.path.join(tmp, name + "_q", "run.tsv")) as f:
                    runs[name] = f.read()
        check(runs["plain"] == runs["dp"] and len(runs["plain"]) > 0,
              "run_repconc_eval --data_parallel at world 1 writes the "
              "one-process run.tsv")
        check(np.array_equal(np.load(os.path.join(tmp, "plain_c", "codes.npy")),
                             np.load(os.path.join(tmp, "dp_c", "codes.npy"))),
              "the --data_parallel corpus codes equal the one-process codes")
        out["cli"] = {"docs": len(corpus), "queries": len(qs),
                      "plain_s": secs["plain"], "data_parallel_s": secs["dp"]}

        # one stage-1 step (the CLI's defaults, dropout on) and one stage-2
        # step, from train_stage1's weights, with mesh= and without
        os.makedirs(os.path.join(tmp, "stage1"))
        tpaths = write_training_files(os.path.join(tmp, "stage1"),
                                      *synthetic_data(n_docs=8192,
                                                      n_queries=1024,
                                                      seed=SEED + 1))
        dataset = QDRelDataset(tpaths["qrels"], tpaths["queries"],
                               tpaths["corpus"], negative="random",
                               negative_per_query=1, sep_token=tok.sep_token)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in next(
            batch_iterator(dataset, FinetuneCollator(tok, 16, 128), 64,
                           seed=SEED)).items()}
        # "again": the plain step a second time, the card's own run-to-run
        # floor (the embedding and gather backwards accumulate with atomics)
        hp = stage1.Stage1Hparams(total_steps=10)
        steps, fns = {}, {}
        for name, m in (("plain", None), ("mesh", mesh), ("again", None)):
            model = copy.deepcopy(stage1_model)
            tx = stage1.make_optimizer(hp, model)
            fns[name] = stage1.make_train_step(model, hp, tx, m)
            steps[name] = step_result(model, fns[name](
                batch, torch.Generator().manual_seed(SEED)))
        gaps1 = step_gaps(steps["plain"], steps["mesh"], hp.learning_rate,
                          hp.centroid_learning_rate)
        check_step_gaps(gaps1, "world-1 stage-1 step with mesh=")
        seeds = torch.Generator().manual_seed(SEED)
        out["stage1_step"] = {
            "plain_ms": time_ms(lambda: fns["plain"](batch, seeds), reps=3,
                                warmup=1),
            "mesh_ms": time_ms(lambda: fns["mesh"](batch, seeds), reps=3,
                               warmup=1),
            "max_abs_gap": exact_gaps(steps["plain"], steps["mesh"]),
            "plain_again_gap": exact_gaps(steps["plain"], steps["again"]),
            "bars": gaps1}
        del steps, fns, model, tx
        torch.cuda.empty_cache()

        g = torch.Generator(device=dev).manual_seed(SEED + 5)
        codes = torch.randint(0, K, (N, M), generator=g, device=dev,
                              dtype=torch.uint8)
        index = CudaADCIndex(codes, stage1_model.centroids.detach(),
                             device=dev)
        del codes
        os.makedirs(os.path.join(tmp, "stage2"))
        qpaths = write_query_files(os.path.join(tmp, "stage2"), 256, N, 30,
                                   SEED + 7)
        qset = QueryDataset(qpaths["qrels"], qpaths["queries"],
                            np.arange(N, dtype=np.int64))
        batch = {k: torch.as_tensor(v).to(dev) for k, v in next(
            batch_iterator(qset, QueryCollator(tok, 32), 128,
                           seed=SEED)).items()}
        hp2 = stage2.Stage2Hparams(total_steps=10)
        steps = {}
        for name, m in (("plain", None), ("mesh", mesh), ("again", None)):
            model = copy.deepcopy(stage1_model)
            tx = stage1.make_optimizer(hp2.as_stage1(), model)
            step = stage2.make_train_step(model, hp2, tx, index.codes,
                                          index.N, mesh=m)
            steps[name] = step_result(model, step(
                batch, torch.Generator().manual_seed(SEED)))
        gaps2 = step_gaps(steps["plain"], steps["mesh"], hp2.learning_rate,
                          hp2.centroid_learning_rate)
        check_step_gaps(gaps2, "world-1 stage-2 step with mesh=")
        out["stage2_step"] = {
            "max_abs_gap": exact_gaps(steps["plain"], steps["mesh"]),
            "plain_again_gap": exact_gaps(steps["plain"], steps["again"]),
            "bars": gaps2}
        del steps, model, tx, index
        torch.cuda.empty_cache()
    launches = launch_counts()
    check(launches["adc_group_max"] > 0 and launches["adc_filter"] > 0
          and all(launches[f"ivf_{p}_{k}"] > 0 for p in ("group_max", "filter")
                  for k in ("bf16", "i8")),
          f"the phase ran K1's and K2 / K3's passes ({launches})")
    out["phase_s"] = time.perf_counter() - t_phase
    emit("data_parallel", launches=launches, **out)
    print("data_parallel flat " + " ".join(
        f"{k} {v:.4f}" for k, v in out["flat"].items())
        + " ivf " + " ".join(f"{lut}_{k} {v:.4f}" for lut in ("bf16", "int8")
                             for k, v in out["ivf"][lut].items())
        + " stage1_plain_ms {plain_ms:.3f} stage1_mesh_ms {mesh_ms:.3f}"
        .format(**out["stage1_step"]), flush=True)
    for st in ("stage1_step", "stage2_step"):
        print(f"data_parallel {st} mesh-vs-plain gap "
              f"{out[st]['max_abs_gap']} plain-vs-plain gap "
              f"{out[st]['plain_again_gap']}", flush=True)
    print(card_line(), flush=True)
    return dict(launches=launches)


def m12_hf_config():
    """The HF config.json of the M=12 checkpoint's encoder (the keys of
    artifacts/r5h_export_hf.tar's export_hf/config.json that the port
    reads): bert-base widths, a 7,905-word vocabulary, mean pooling,
    METRIC_IP."""
    return {"architectures": ["BertModel"], "model_type": "bert",
            "vocab_size": 7905, "hidden_size": 768, "num_hidden_layers": 12,
            "num_attention_heads": 12, "intermediate_size": 3072,
            "max_position_embeddings": 512, "type_vocab_size": 2,
            "layer_norm_eps": 1e-12, "hidden_act": "gelu",
            "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1,
            "pad_token_id": 0, "pooling": "mean",
            "similarity_metric": "METRIC_IP"}


def write_pipeline_files(root: str, corpus, queries, qrels, n_train: int):
    """corpus.tsv, and the first n_train queries as the train split, the
    rest as the dev split (queries.*.tsv, qrels.*.tsv)."""
    qids = list(queries)
    paths = {"corpus": os.path.join(root, "corpus.tsv")}
    with open(paths["corpus"], "w") as f:
        f.writelines(f"{d}\t{t}\n" for d, t in corpus.items())
    for split, part in (("train", qids[:n_train]), ("dev", qids[n_train:])):
        paths[f"queries_{split}"] = os.path.join(root, f"queries.{split}.tsv")
        paths[f"qrels_{split}"] = os.path.join(root, f"qrels.{split}.tsv")
        with open(paths[f"queries_{split}"], "w") as f:
            f.writelines(f"{q}\t{queries[q]}\n" for q in part)
        with open(paths[f"qrels_{split}"], "w") as f:
            f.writelines(f"{q} 0 {d} {r}\n" for q in part
                         for d, r in qrels[q].items())
    return paths


def valid_set_args(paths, split: str, out: str, mode):
    """run_gen_valid_set's arguments over the `split` queries into `out`."""
    return (["--input_corpus_path", paths["corpus"],
             "--input_query_path", paths[f"queries_{split}"],
             "--input_qrel_path", paths[f"qrels_{split}"]] + mode
            + ["--output_corpus_path", os.path.join(out, "corpus.tsv"),
               "--output_query_path", os.path.join(out, "queries.tsv"),
               "--output_qrel_path", os.path.join(out, "qrels.tsv")])


def dense_topk_agrees(queries, corpus, scores, ids, rows: int = 1 << 18):
    """The fp32 top-k (scores, row ids) of `queries` against a plain fp64
    top-k over the same corpus (on the device, `rows` rows at a time): the
    same ids except where fp64 scores lie within the fp32 rounding of a
    768-term dot product (1e-5 of the largest |score|) of the k-th, and
    the scores within that rounding. Returns (ok, the bar, the largest
    score gap)."""
    import torch

    q = queries.double()
    k = ids.shape[1]
    best_s = torch.full((q.shape[0], k), -torch.inf, dtype=torch.float64,
                        device=q.device)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=q.device)
    for start in range(0, corpus.shape[0], rows):
        s, i = torch.topk(q @ corpus[start:start + rows].double().T,
                          min(k, corpus.shape[0] - start), dim=1)
        s = torch.cat([best_s, s], 1)
        i = torch.cat([best_i, i + start], 1)
        best_s, pos = torch.topk(s, k, dim=1)
        best_i = torch.gather(i, 1, pos)
    bar = 1e-5 * float(best_s.abs().max())
    gap = float((scores.double() - best_s).abs().max())
    ok = gap <= bar
    for r in range(q.shape[0]):
        mine = set(ids[r].tolist())
        plain = set(best_i[r].tolist())
        for j in mine ^ plain:  # in one top-k only: at the k-th score
            s_j = float(q[r] @ corpus[j].double())
            ok &= abs(s_j - float(best_s[r, -1])) <= bar
    return ok, bar, gap


def phase_dense_front(dev, root: str):
    """Stages 0 and 2-5 chained at the M=12 checkpoint's encoder widths,
    through the functions the CLIs call (HashTokenizer stands in, which
    keeps this phase's data; pipeline_recipe runs the CLIs and the real
    tokenizer), then stage 6's retrieval and miner from the
    warm-up index. Leaves root/warmup_model for train_stage1."""
    import copy

    import numpy as np
    import torch
    from repconc_tpu_torch.cli import (run_customize_dense, run_dense_eval,
                                       run_extract_hardneg, run_gen_valid_set,
                                       run_train_dense, run_warmup)
    from repconc_tpu_torch.core.checkpoint import atomic_np_save
    from repconc_tpu_torch.core.profiling import Stopwatch
    from repconc_tpu_torch.eval.encode import (clear_encode_cache,
                                               encode_corpus, encode_queries,
                                               encode_texts)
    from repconc_tpu_torch.eval.pipeline import repconc_retrieval
    from repconc_tpu_torch.eval.run_io import (load_corpus, load_queries,
                                               write_run_tsv)
    from repconc_tpu_torch.eval.trec import evaluate_run, parse_qrels
    from repconc_tpu_torch.index.flat import batch_flat_search
    from repconc_tpu_torch.models.auto import (load_dense_encoder,
                                               save_hf_checkpoint)
    from repconc_tpu_torch.models.repconc_model import (
        RepConcModel, from_dense_encoder, from_pretrained, init_random_)
    from repconc_tpu_torch.train import stage1
    from repconc_tpu_torch.train.data import (FinetuneCollator, QDRelDataset,
                                              batch_iterator)

    t_phase = time.perf_counter()
    out = {}
    config = m12_config()
    tok = HashTokenizer(config.encoder.vocab_size)
    sep = tok.sep_token

    # the HF dir: seeded weights written by save_hf_checkpoint, read back
    src, hf_dir = os.path.join(root, "src"), os.path.join(root, "hf")
    os.makedirs(src)
    with open(os.path.join(src, "config.json"), "w") as f:
        json.dump(m12_hf_config(), f)
    weights = init_random_(RepConcModel(config), torch.Generator().manual_seed(
        SEED + 4), std=0.02).encoder.state_dict()
    t0 = time.perf_counter()
    save_hf_checkpoint(hf_dir, src, weights, config.encoder)
    cfg, on_card, metric = load_dense_encoder(hf_dir, device=dev)
    out["hf_write_read_s"] = time.perf_counter() - t0
    check(set(on_card) == set(weights) and all(
        torch.equal(on_card[k].cpu(), v) for k, v in weights.items()),
        "every tensor of the HF dir reads back bit-equal")
    check(cfg.pooling == "mean" and metric == "METRIC_IP"
          and cfg.vocab_size == 7905, "the HF dir's config reads back")
    del weights, on_card

    corpus, queries, qrels = synthetic_data(n_docs=16_384, n_queries=1280,
                                            seed=SEED + 5)
    paths = write_pipeline_files(root, corpus, queries, qrels, n_train=1024)

    # stage 0: the run-free validation set, dense pre-training, the export
    valid0 = os.path.join(root, "valid0")
    run_gen_valid_set.main(valid_set_args(paths, "dev", valid0,
                                          ["--random_sample", "2048"]))
    valid_set = (load_corpus(os.path.join(valid0, "corpus.tsv"), sep),
                 load_queries(os.path.join(valid0, "queries.tsv")),
                 parse_qrels(os.path.join(valid0, "qrels.tsv")))
    model = from_dense_encoder(hf_dir, MCQ_M=1, similarity_metric="METRIC_IP",
                               pooling="mean", device=dev)
    dataset = QDRelDataset(paths["qrels_train"], paths["queries_train"],
                           paths["corpus"], negative="random",
                           negative_per_query=1, sep_token=sep, max_positives=8)
    collator = FinetuneCollator(tok, 16, 128, max_positives=8)
    steps, batch_size = 4, 256
    hp = stage1.Stage1Hparams(
        learning_rate=1e-4, centroid_learning_rate=0.0, weight_decay=0.01,
        warmup_steps=100, total_steps=steps, negative_per_query=1,
        quantize=False, cache_chunk_size=128, seed=SEED, logging_steps=1,
        eval_steps=steps, save_steps=steps)
    pretrain = os.path.join(root, "dense_pretrain")
    logs = []
    reset_launches()
    t0 = time.perf_counter()
    trained = stage1.train(
        model, batch_iterator(dataset, collator, batch_size, seed=SEED), hp,
        pretrain, tokenizer=tok, valid_set=valid_set, log_fn=logs.append,
        device=dev)
    torch.cuda.synchronize()
    out["stage0_train_call_s"] = time.perf_counter() - t0
    out["stage0_launches"] = launch_counts()
    check(out["stage0_launches"]["adc_group_max"] == 0
          and out["stage0_launches"]["adc_filter"] == 0,
          "stage 0's validation is the dense search: no K1 launch")
    check(trained["step"] == steps and all(
        np.isfinite(h["loss"]) for h in trained["history"]),
        f"stage 0 trained {trained['step']} steps with finite losses")
    evals = [m for m in logs if "eval_MRR@10" in m]
    check(len(evals) == 1 and 0.0 <= evals[0]["eval_MRR@10"] <= 1.0,
          "one dense validation with MRR@10 in [0, 1]")
    export = run_train_dense.export_best(pretrain, hf_dir, dev)
    best = from_pretrained(os.path.join(pretrain, "best"), device="cpu")
    _, exported, _ = load_dense_encoder(export, device="cpu")
    check(all(torch.equal(exported[k], v)
              for k, v in best.encoder.state_dict().items()),
          "export_hf holds best/'s encoder bit for bit")
    del best, exported
    # the step time on the trained model at the recipe's batch (median of
    # 3 after 1), and its peak memory
    full = {k: torch.as_tensor(v).to(dev) for k, v in next(batch_iterator(
        dataset, collator, batch_size, seed=SEED + 1)).items()}
    tx = stage1.make_optimizer(hp, model)
    step_fn = stage1.make_train_step(model, hp, tx)
    seeds = torch.Generator().manual_seed(SEED)
    out["stage0_step_ms"] = time_ms(lambda: step_fn(full, seeds), reps=3,
                                    warmup=1)
    torch.cuda.reset_peak_memory_stats()
    step_fn(full, seeds)
    torch.cuda.synchronize()
    out["stage0_peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["stage0_history"] = trained["history"]
    out["stage0_eval"] = evals[0]
    del model, trained, full, tx, step_fn
    torch.cuda.empty_cache()

    # stage 2: customize the export
    dense_dir = os.path.join(root, "dense_model")
    run_customize_dense.main(["--model_name_or_path", export,
                              "--similarity_metric", "METRIC_IP",
                              "--pooling", "mean", "--output_dir", dense_dir])

    # stage 3: dense eval through the resumable cache, top-200
    dense_out = os.path.join(root, "dense")
    model = run_dense_eval.load_model(dense_dir, device=dev)
    sw = Stopwatch()
    shards = os.path.join(dense_out, "encode_shards")
    full_corpus = load_corpus(paths["corpus"], sep)
    with sw("encode_corpus"):
        embeds, corpus_ids = encode_corpus(
            full_corpus, model, tok, 512, batch_size=256,
            output="continuous_embedding", device=dev, stopwatch=sw,
            cache_dir=shards)
    emb_path = os.path.join(dense_out, "corpus_embeds.npy")
    ids_path = os.path.join(dense_out, "corpus_ids.npy")
    atomic_np_save(emb_path, embeds)
    atomic_np_save(ids_path, corpus_ids)
    clear_encode_cache(shards)
    check(embeds.shape == (len(full_corpus), config.hidden_size)
          and embeds.dtype == np.float32 and bool(np.isfinite(embeds).all()),
          "corpus embeddings (N, 768)")
    dev_queries = load_queries(paths["queries_dev"])
    with sw("encode_queries"):
        q_embeds, query_ids = encode_queries(dev_queries, model, tok, 512,
                                             device=dev)
    with sw("search"):
        scores, topk_ids = batch_flat_search(query_ids, q_embeds, corpus_ids,
                                             embeds, topk=200, device=dev)
    run_path = os.path.join(dense_out, "run.tsv")
    write_run_tsv(run_path, query_ids, scores, topk_ids)
    metrics = evaluate_run(paths["qrels_dev"], run_path)
    row_of = {c: j for j, c in enumerate(corpus_ids)}
    rows = torch.tensor([[row_of[d] for d in r] for r in topk_ids], device=dev)
    ok, bar, gap = dense_topk_agrees(
        torch.as_tensor(q_embeds, device=dev),
        torch.as_tensor(embeds, device=dev),
        torch.as_tensor(scores, device=dev), rows)
    check(ok, f"stage 3's top-200 equals a plain fp64 top-200 except ties "
              f"(bar {bar}, gap {gap})")
    # the 1,024 shortest docs (the last four batches, encoded alike) on the
    # CPU: agreement to 1e-4 shows TF32 is off
    texts = [full_corpus[c] for c in corpus_ids[-1024:]]
    on_cpu = encode_texts(texts, copy.deepcopy(model).cpu(), tok, 512,
                          batch_size=256, device="cpu")
    cpu_gap = float(np.abs(on_cpu - embeds[-1024:]).max())
    check(cpu_gap <= 1e-4, f"stage-3 embeddings card vs CPU within 1e-4 "
                           f"({cpu_gap})")
    t = sw.totals
    out.update(stage3_encode_s=t["encode_corpus"],
               stage3_docs_per_s=len(full_corpus) / t["encode_corpus"],
               stage3_tokenize_s=t["tokenize"],
               stage3_search_s=t["search"], stage3_mrr_at_10=metrics["mrr"][
                   "MRR@10"], stage3_card_vs_cpu=cpu_gap,
               stage3_topk_gap=gap)
    del model

    # stage 4: the validation set from the dense run
    valid = os.path.join(root, "valid")
    run_gen_valid_set.main(valid_set_args(
        paths, "dev", valid, ["--input_run_path", run_path, "--topk", "100"]))
    kept = load_corpus(os.path.join(valid, "corpus.tsv"), sep)
    judged = {d for q in dev_queries for d in qrels[q]}
    check(judged <= set(kept) and len(kept) <= len(judged) + 256 * 100,
          f"the validation corpus holds every judged doc ({len(kept)} docs)")
    out["stage4_valid_docs"] = len(kept)

    # stage 5: the OPQ warm-up at the CLI's defaults
    warm_dir = os.path.join(root, "warmup_model")
    index_dir = os.path.join(root, "warmup_index")
    t0 = time.perf_counter()
    run_warmup.main(["--model_name_or_path", dense_dir,
                     "--MCQ_M", str(config.MCQ_M),
                     "--input_corpus_embed_path", emb_path,
                     "--input_corpus_ids_path", ids_path,
                     "--output_model_dir", warm_dir,
                     "--output_index_dir", index_dir, "--device", str(dev)])
    torch.cuda.synchronize()
    out["stage5_warmup_s"] = time.perf_counter() - t0
    warm = from_pretrained(warm_dir, device=dev)
    codes = np.load(os.path.join(index_dir, "codes.npy"))
    M = config.MCQ_M
    check(warm.config.MCQ_M == M and warm.config.MCQ_K == 256
          and codes.shape == (len(full_corpus), M) and codes.dtype == np.uint8
          and np.array_equal(np.load(os.path.join(index_dir,
                                                  "corpus_ids.npy")),
                             corpus_ids), "the warm-up dirs load in the port")
    R = warm.rotation.detach()
    orth = float((R @ R.T - torch.eye(R.shape[0], device=dev)).abs().max())
    check(orth <= 1e-4, f"the warm-up rotation is orthogonal ({orth})")
    # the warm-up model's own codes for 2,048 docs against codes.npy
    n_chk, dsub = min(2048, len(full_corpus)), config.dsub
    own = encode_texts([full_corpus[c] for c in corpus_ids[:n_chk]], warm,
                       tok, 512, batch_size=256, output="code", device=dev)
    rotated = (torch.as_tensor(embeds[:n_chk], device=dev) @ R.T).double()
    cent = warm.centroids.detach().double()
    # a near-tie: the two centroids' fp64 distances differ by less than
    # the fp32 rounding of ||x||^2 - 2 x.c + ||c||^2 over 64 terms, taken
    # as 1e-5 of the operands' squared norms
    differ = torch.nonzero(torch.as_tensor(own != codes[:n_chk]))
    worst = 0.0
    for r, m in differ.tolist():
        sub = rotated[r, m * dsub:(m + 1) * dsub]
        c_own, c_idx = cent[m, int(own[r, m])], cent[m, int(codes[r, m])]
        scale = float((sub * sub).sum() + torch.maximum(
            (c_own * c_own).sum(), (c_idx * c_idx).sum()))
        gap = abs(float(((sub - c_own) ** 2).sum() - ((sub - c_idx) ** 2).sum()))
        worst = max(worst, gap / scale)
    check(worst <= 1e-5 and len(differ) <= 0.01 * own.size,
          f"codes.npy equals the warm-up model's codes except fp32 "
          f"near-ties ({len(differ)} differ, worst gap {worst} of the "
          f"operands' squared norms)")
    out.update(stage5_codes_differ=len(differ), stage5_worst_gap=worst,
               stage5_rotation_orth=orth)

    # stage 6: the warm-up model retrieves the train queries' top-210 from
    # the warm-up index (K1's two passes), and the miner reads the run
    train_queries = load_queries(paths["queries_train"])
    reset_launches()
    t0 = time.perf_counter()
    run6, *_ = repconc_retrieval(warm, tok, full_corpus, train_queries,
                                 max_seq_length=512, topk=210, codes=codes,
                                 corpus_ids=corpus_ids, device=dev)
    torch.cuda.synchronize()
    out["stage6_retrieval_s"] = time.perf_counter() - t0
    out["stage6_launches"] = launch_counts()
    check(out["stage6_launches"]["adc_group_max"] > 0
          and out["stage6_launches"]["adc_filter"] > 0,
          f"stage 6 ran both passes of K1 ({out['stage6_launches']})")
    ranked = [sorted(run6[q].items(), key=lambda kv: -kv[1])
              for q in sorted(run6)]
    run6_path = os.path.join(root, "warmup_run.tsv")
    write_run_tsv(run6_path, sorted(run6),
                  np.array([[s for _, s in r] for r in ranked]),
                  np.array([[d for d, _ in r] for r in ranked]))
    hardneg = os.path.join(root, "hardneg.json")
    run_extract_hardneg.main(["--run_path", run6_path, "--qrel_path",
                              paths["qrels_train"], "--topk", "200",
                              "--output_path", hardneg])
    with open(hardneg) as f:
        pools = json.load(f)
    check(len(pools) == len(train_queries) and all(
        len(v) >= 199 for v in pools.values()), "the miner's negative pools")
    del warm
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    emit("dense_front", **out)
    print(f"dense_front stage0_step_ms {out['stage0_step_ms']:.3f} "
          f"(batch {batch_size}) peak_memory_gb "
          f"{out['stage0_peak_memory_gb']:.3f} stage3_docs_per_s "
          f"{out['stage3_docs_per_s']:.1f} stage5_warmup_s "
          f"{out['stage5_warmup_s']:.3f}", flush=True)
    print(card_line(), flush=True)
    return dict(warmup_dir=warm_dir, launches=out["stage6_launches"],
                stage0_launches=out["stage0_launches"])


def phase_dense_scale(dev):
    """Stages 3 and 5 at MS MARCO's size, the encoder bypassed: 8,841,823 x
    768 fp32 embeddings made on the card, searched by batch_flat_search and
    warmed up by warmup_from_embeds at the CLI's defaults."""
    import numpy as np
    import torch
    from repconc_tpu_torch.core.profiling import Stopwatch
    from repconc_tpu_torch.index import kmeans, opq
    from repconc_tpu_torch.index.flat import batch_flat_search
    from repconc_tpu_torch.models.repconc_model import RepConcModel
    from repconc_tpu_torch.train.warmup import warmup_from_embeds

    t_phase = time.perf_counter()
    config = m12_config()
    N, D, rank, Q, topk = MSMARCO_PASSAGES, config.hidden_size, 64, 1200, 200
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    # correlated rows: a seeded rank-64 factor with falling scales, plus
    # noise, so that OPQ has a rotation to find
    mix = torch.randn((rank, D), generator=g, device=dev)
    mix = mix / mix.norm(dim=1, keepdim=True) * torch.linspace(
        3.0, 0.1, rank, device=dev)[:, None]

    def rows(n):
        return (torch.randn((n, rank), generator=g, device=dev) @ mix
                + 0.05 * torch.randn((n, D), generator=g, device=dev))

    t0 = time.perf_counter()
    corpus = torch.empty((N, D), device=dev)
    for start in range(0, N, 1 << 20):
        corpus[start:start + (1 << 20)] = rows(min(1 << 20, N - start))
    queries = rows(Q).cpu().numpy()
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    corpus_ids = np.arange(N)
    qids = np.arange(Q)

    # stage 3's search: 1200 queries, top-200, the corpus on the card
    times = []
    for _ in range(4):  # 1 warm-up, median of 3
        t0 = time.perf_counter()
        scores, ids = batch_flat_search(qids, queries, corpus_ids, corpus,
                                        topk=topk, batch_size=Q, device=dev)
        times.append(time.perf_counter() - t0)
    search_ms = statistics.median(times[1:]) * 1e3
    bound = bound_ms(N * D * 4 + Q * D * 4 + Q * topk * 12, 2.0 * Q * N * D)
    ok, bar, gap = dense_topk_agrees(
        torch.as_tensor(queries[:16], device=dev), corpus,
        torch.as_tensor(scores[:16], device=dev),
        torch.as_tensor(ids[:16], device=dev))
    check(ok, f"the top-200 of 16 queries equals a plain fp64 top-200 "
              f"except ties (bar {bar}, gap {gap})")

    # stage 5's warm-up at the CLI's defaults on the resident corpus
    model = RepConcModel(config).to(dev)
    sw = Stopwatch()
    model, codes = warmup_from_embeds(corpus, model, device=dev, stopwatch=sw)
    M = config.MCQ_M
    check(codes.shape == (N, M) and codes.dtype == np.uint8,
          "codes (N, 12) uint8")
    R = model.rotation.detach()
    orth = float((R @ R.T - torch.eye(D, device=dev)).abs().max())
    check(orth <= 1e-4, f"the OPQ rotation is orthogonal ({orth})")
    train = kmeans.subsample_for_training(corpus, 1 << 18, 2022)
    rotated = train @ R.T
    cent = model.centroids.detach()
    opq_mse = float(((rotated - opq._pq_reconstruct(rotated, cent)) ** 2
                     ).sum(-1).mean())
    t0 = time.perf_counter()
    pq_cent, _ = kmeans.pq_fit(train, M, config.MCQ_K, iters=25, seed=SEED)
    torch.cuda.synchronize()
    pq_s = time.perf_counter() - t0
    pq_mse = float(((train - opq._pq_reconstruct(train, pq_cent)) ** 2
                    ).sum(-1).mean())
    check(opq_mse < pq_mse, f"OPQ's reconstruction MSE ({opq_mse}) is below "
                            f"plain PQ's ({pq_mse}) on the same subsample")
    # one chunk's codes against the model's own PQ assignment
    chunk = corpus[:1 << 16] @ R.T
    check(np.array_equal(kmeans.pq_assign(chunk, cent).cpu().numpy(),
                         codes[:1 << 16]), "codes of the first chunk")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t = sw.totals
    emit("dense_scale", N=N, D=D, Q=Q, topk=topk, make_s=make_s,
         search_ms=search_ms, search_ms_all=[x * 1e3 for x in times],
         search_bound_ms=bound[0], search_bound_by=bound[1],
         topk_bar=bar, topk_gap=gap, opq_fit_s=t["opq_fit"],
         pq_encode_s=t["encode"], opq_mse=opq_mse, pq_mse=pq_mse,
         plain_pq_fit_s=pq_s, rotation_orth=orth, peak_memory_gb=peak_gb,
         phase_s=time.perf_counter() - t_phase)
    print(f"dense_scale search_ms {search_ms:.3f} bound_ms {bound[0]:.3f} "
          f"({bound[1]}) opq_fit_s {t['opq_fit']:.3f} pq_encode_s "
          f"{t['encode']:.3f} peak_memory_gb {peak_gb:.3f}", flush=True)
    print(card_line(), flush=True)
    del corpus, model, train, rotated, chunk, pq_cent
    torch.cuda.empty_cache()
    return dict(search_ms=search_ms, bound=bound)


def recipe_env(root: str) -> dict:
    """The environment of the recipe's processes: this interpreter's
    directory first on PATH, so that its `python` runs the CLIs, and a
    `transformers` package that raises on import first on PYTHONPATH (the
    rest of PYTHONPATH kept)."""
    import shutil

    block = os.path.join(root, "block", "transformers")
    os.makedirs(block)
    with open(os.path.join(block, "__init__.py"), "w") as f:
        f.write("raise ImportError('transformers is not installed here')\n")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ["PATH"], PYTHONPATH=os.path.dirname(block) + (
                   os.pathsep + path if path else ""), DEVICE="cuda")
    python = shutil.which("python", path=env["PATH"])
    check(python is not None and os.path.samefile(python, sys.executable),
          f"`python` on the recipe's PATH is this interpreter ({python})")
    return env


def run_logged(cmd, env, log_path: str, timeout: int = 600) -> float:
    """Run `cmd` with its output in `log_path`; its wall seconds. A failure
    raises with the log's tail."""
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.run(cmd, env=env, stdout=log, stderr=subprocess.STDOUT,
                              timeout=timeout)
    if proc.returncode != 0:
        with open(log_path) as f:
            tail = f.read()[-4000:]
        raise RuntimeError(f"{' '.join(cmd)} exited {proc.returncode}:\n{tail}")
    return time.perf_counter() - t0


def start_recipe_data() -> dict:
    """pipeline_recipe's data step, `make_pipeline_data.py synth` (a CPU-only
    process), started in a thread before the first phase so that it runs
    beside them; phase_pipeline_recipe joins it. Returns the recipe's
    temporary directory, its processes' environment, the workspace and the
    thread."""
    import threading

    from repconc_tpu_torch.recipes.recipe_runs import RECIPE_DOCS, RECIPE_LAYERS

    repo = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory()
    env = recipe_env(tmp.name)
    out = {"tmp": tmp, "env": env, "ws": os.path.join(tmp.name, "ws")}

    def work():
        try:
            out["data_s"] = run_logged(
                ["python", "-m", "repconc_tpu_torch.recipes.make_pipeline_data",
                 "synth", "--out_dir", out["ws"], "--n_docs", str(RECIPE_DOCS),
                 "--hidden_layers", str(RECIPE_LAYERS)],
                dict(env, PYTHONPATH=repo + os.pathsep + env["PYTHONPATH"]),
                os.path.join(tmp.name, "data.log"))
        except Exception as e:  # raised again where the phase joins
            out["error"] = e

    out["thread"] = threading.Thread(target=work)
    out["thread"].start()
    return out


def phase_pipeline_recipe(dev, data: dict):
    """The port's recipe as a user runs it: make_pipeline_data synth (run
    beside the earlier phases, start_recipe_data), then
    `bash repconc_tpu_torch/recipes/run_pipeline.sh <env> <stage>` for stages
    2-10 on the card (subprocesses, the real CLIs, the port's WordPiece
    tokenizer, `transformers` not importable), then stage 8 again with IVF=1;
    then stage 8 in this process through run_repconc_eval.main with the
    launch counters, flat and IVF, whose metric.json must equal the
    recipe's. Each stage's files, finite MRR@10 in the dense, conc and jpq
    metric.json, each stage's wall time."""
    import numpy as np
    import torch
    from repconc_tpu_torch.cli import run_repconc_eval
    from repconc_tpu_torch.recipes import make_pipeline_data
    from repconc_tpu_torch.recipes.recipe_runs import (RECIPE_CUTS,
                                                       RECIPE_DOCS,
                                                       RECIPE_ENV,
                                                       RECIPE_LAYERS,
                                                       RECIPE_STAGES,
                                                       stage_outputs,
                                                       write_env)

    t_phase = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    driver = os.path.join(repo, "repconc_tpu_torch", "recipes",
                          "run_pipeline.sh")
    torch.cuda.empty_cache()
    emit("pipeline_recipe_setup", cuts=RECIPE_CUTS, env=RECIPE_ENV,
         docs=RECIPE_DOCS, encoder_layers=RECIPE_LAYERS)
    data["thread"].join()
    if "error" in data:
        raise data["error"]
    with data["tmp"] as root:
        env, ws = data["env"], data["ws"]
        blocked = subprocess.run(["python", "-c", "import transformers"],
                                 env=env, capture_output=True, text=True)
        check(blocked.returncode != 0 and "not installed here" in blocked.stderr,
              "transformers is not importable in the recipe's processes")
        out_root = os.path.join(ws, "experiments", "synth")
        stage_s = {"data": data["data_s"]}
        env_file = os.path.join(root, "synth.env")
        write_env(env_file, ws)
        outputs = stage_outputs()
        for stage in RECIPE_STAGES:
            stage_s[stage] = run_logged(
                ["bash", driver, env_file, stage], env,
                os.path.join(root, f"stage{stage}.log"))
            missing = [p for p in outputs[stage]
                       if not os.path.exists(os.path.join(out_root, p))]
            check(not missing, f"stage {stage} wrote its files ({missing})")
            print(f"pipeline_recipe stage {stage} {stage_s[stage]:.1f} s",
                  flush=True)
        metrics = {}
        for name in ("dense/dev", "m12/conc_index/dev", "m12/jpq_index/dev"):
            with open(os.path.join(out_root, name, "metric.json")) as f:
                metrics[name] = json.load(f)
            check(np.isfinite(metrics[name]["mrr"]["MRR@10"]),
                  f"{name}/metric.json has a finite MRR@10")
        flat_metric = metrics["m12/conc_index/dev"]
        # stage 8 skips a query dir that holds a metric.json: the flat run's
        # dir is moved aside, as a user keeping both would
        os.rename(os.path.join(out_root, "m12/conc_index/dev"),
                  os.path.join(out_root, "m12/conc_index/dev_flat"))
        stage_s["8_ivf"] = run_logged(
            ["bash", driver, env_file, "8"], dict(env, IVF="1"),
            os.path.join(root, "stage8_ivf.log"))
        with open(os.path.join(out_root, "m12/conc_index/dev/metric.json")) as f:
            ivf_metric = json.load(f)
        check(np.isfinite(ivf_metric["mrr"]["MRR@10"]),
              "the IVF stage 8's metric.json has a finite MRR@10")
        print(f"pipeline_recipe stage 8 IVF=1 {stage_s['8_ivf']:.1f} s",
              flush=True)

        # stage 8 in this process, as the recipe runs it, with the counters
        data = os.path.join(ws, "data")
        inproc = os.path.join(root, "inproc")
        conc = os.path.join(out_root, "m12", "conc")  # best_or_final
        conc = os.path.join(conc, "best" if os.path.isdir(
            os.path.join(conc, "best")) else "final")
        args = ["--model_name_or_path", conc,
                "--corpus_path", os.path.join(data, "corpus.tsv"),
                "--query_path", os.path.join(data, "queries.dev.small.tsv"),
                "--qrel_path", os.path.join(data, "qrels.dev.small.tsv"),
                "--out_corpus_dir", os.path.join(inproc, "index"),
                "--max_seq_length", "512", "--topk", "1000"]
        launches, inproc_s, inproc_metric = {}, {}, {}
        for kind, extra in (("flat", []), ("ivf", [
                "--index_type", "ivf", "--nlist", RECIPE_ENV["NLIST"],
                "--nprobe", RECIPE_ENV["NPROBE"]])):
            out_dir = os.path.join(inproc, kind)
            reset_launches()
            t0 = time.perf_counter()
            run_repconc_eval.main(args + ["--out_query_dir", out_dir] + extra)
            torch.cuda.synchronize()
            inproc_s[kind] = time.perf_counter() - t0
            launches[kind] = launch_counts()
            with open(os.path.join(out_dir, "metric.json")) as f:
                inproc_metric[kind] = json.load(f)
        check(np.array_equal(
            np.load(os.path.join(inproc, "index", "codes.npy")),
            np.load(os.path.join(out_root, "m12/conc_index/codes.npy"))),
            "the in-process encode's codes equal the recipe's bit for bit")
        check(inproc_metric["flat"] == flat_metric
              and inproc_metric["ivf"] == ivf_metric,
              "the in-process stage 8's metric.json equals the recipe's, "
              "flat and IVF")
        # the BEIR twin over a BEIR-layout copy of the dev split, with stage
        # 8's model, length (the recipe's MAX_DOC_LEN_EVAL) and batch
        beir = os.path.join(root, "beir")
        make_pipeline_data.beir_layout(data, "dev.small", beir)
        beir_out = os.path.join(root, "beir_out")
        stage_s["beir_eval"] = run_logged(
            ["bash", os.path.join(repo, "repconc_tpu_torch", "recipes",
                                  "beir_eval.sh"), beir, beir_out, conc],
            dict(env, MAX_SEQ_LEN="512", EVAL_BATCH="256"),
            os.path.join(root, "beir_eval.log"))
        with open(os.path.join(beir_out, "test", "metric.json")) as f:
            beir_metric = json.load(f)
        check(beir_metric == inproc_metric["flat"],
              "beir_eval.sh's metric.json equals stage 8's")
        print(f"pipeline_recipe beir_eval {stage_s['beir_eval']:.1f} s",
              flush=True)
        flat, ivf = launches["flat"], launches["ivf"]
        check(flat["adc_group_max"] > 0 and flat["adc_filter"] > 0
              and flat["adc_scan"] == 0,
              f"the flat stage 8 ran K1's two passes ({flat})")
        check(ivf["ivf_group_max_bf16"] > 0 and ivf["ivf_filter_bf16"] > 0
              and ivf["ivf_scan_bf16"] == 0,
              f"the IVF stage 8 ran K2's two passes ({ivf})")
    phase_s = time.perf_counter() - t_phase
    mrr = {k: v["mrr"]["MRR@10"] for k, v in metrics.items()}
    mrr["m12/conc_index/dev ivf"] = ivf_metric["mrr"]["MRR@10"]
    mrr["beir_eval"] = beir_metric["mrr"]["MRR@10"]
    emit("pipeline_recipe", stage_s=stage_s, mrr_at_10=mrr,
         launches=launches, inproc_stage8_s=inproc_s, cuts=RECIPE_CUTS,
         phase_s=phase_s)
    print("pipeline_recipe stage_s " + " ".join(
        f"{k} {v:.1f}" for k, v in stage_s.items()), flush=True)
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
    "ivf_group_max_bf16": "no single PyTorch call takes run maxima of "
                          "cell-grouped ADC scores",
    "ivf_filter_bf16": "no single PyTorch call keeps the docs of probed "
                       "cells above a per-query threshold",
    "ivf_group_max_i8": "as ivf_group_max_bf16, with per-group scales",
    "ivf_filter_i8": "as ivf_filter_bf16, with per-group scales",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tf32-samples", type=int, default=0,
                    help="measure TRAINED_FP32_BARS' margins instead")
    args = ap.parse_args(argv)
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
    if args.tf32_samples:
        with tempfile.TemporaryDirectory() as root:
            front = phase_dense_front(dev, root)
            for _ in range(2):
                model = phase_train_stage1(dev, front["warmup_dir"])["model"]
                try:
                    phase_train_stage2(dev, model, args.tf32_samples)
                except RuntimeError as e:  # the samples are out already
                    print(f"tf32_samples: {e}", flush=True)
                del model
        print(card_line(), flush=True)
        return 0

    recipe_data = start_recipe_data()
    k1, worst = phase_k1_check(dev)
    topk_checks = phase_k1_topk_check(dev)
    checks = phase_ivf_checks(dev)
    ivf_topk_checks = phase_ivf_topk_check(dev)
    full_scan = phase_full_scan(dev)
    ivf_scale, ivf_breakdown_ms, scale_index = phase_ivf_scale(dev)
    balanced = phase_ivf_balanced(dev, scale_index)
    main_path = phase_main_path(dev)
    held_out = phase_heldout(dev, "heldout_m12")
    held_out_opq = phase_heldout(dev, "heldout_m12_opq")
    ivf_runs, main_ivf_index = phase_ivf_main_path(dev, main_path)
    decoded = phase_ivf_decoded(dev, main_path, main_ivf_index, scale_index,
                                balanced.pop("index"))
    del main_ivf_index
    sweep = phase_ivf_sweep(dev, main_path)
    phase_bf16_main_path(dev, main_path)
    del main_path["cpu_model"], main_path["texts"]
    with tempfile.TemporaryDirectory() as pipeline_root:
        front = phase_dense_front(dev, pipeline_root)
        phase_dense_scale(dev)
        train_run = phase_train_stage1(dev, front["warmup_dir"])
    stage1_model = train_run.pop("model")
    jpq_run = phase_train_stage2(dev, stage1_model)
    parallel = phase_data_parallel(dev, stage1_model, scale_index)
    del stage1_model, scale_index
    recipe = phase_pipeline_recipe(dev, recipe_data)
    phase_stage1_scale(dev)

    # launches on the paths: both passes of the K1 top-k on the flat main
    # path (phase 4) and the held-out search (phase 4b); both passes of the
    # IVF top-k on the IVF path, with K2's scan body for the bf16 LUT and
    # K3's for the int8 LUT (phase 7).
    # K1's score-returning scan, K2 / K3 writing every score, and K4 are on
    # no path: the passes took the place of the first two, and K4 has none
    # in the JAX package either. Their launches there must stay 0; k1_check,
    # k2_check, k3_check and k4_check hold them against their plain versions
    # PR 12's paths: the balanced build's search (K2's passes, K1 for
    # the spill), decoded serving (K1 for the spill merges) and
    # run_ivf_sweep (K1's passes for the exact baseline and the spill,
    # K2's or K3's passes for each nprobe). PR 15's: pipeline_recipe's
    # stage 8 in process, flat and IVF.
    on_paths = [main_path["launches"], held_out["launches"],
                held_out_opq["launches"],
                *ivf_runs.values(),
                *(r["launches"] for r in ivf_scale.values()),
                jpq_run["launches"], balanced["launches"],
                decoded["launches"], decoded["scale_launches"],
                *sweep.values(), parallel["launches"],
                *recipe["launches"].values()]
    # The recipe's paths: pipeline_recipe's stage 8 in process, flat (K1's
    # passes) and IVF (K2's passes; K1's for the spill); and the held-out
    # OPQ leg's search (K1's passes)
    k1_paths = (main_path["launches"], held_out["launches"],
                held_out_opq["launches"], recipe["launches"]["flat"])
    launches = {
        "adc_scan": (sum(r["adc_scan"] for r in on_paths), None),
        "adc_group_max": (sum(r["adc_group_max"] for r in k1_paths),
                          "main_path + heldout_m12 + heldout_m12_opq + "
                          "pipeline_recipe flat"),
        "adc_filter": (sum(r["adc_filter"] for r in k1_paths),
                       "main_path + heldout_m12 + heldout_m12_opq + "
                       "pipeline_recipe flat"),
        "ivf_scan_bf16": (sum(r["ivf_scan_bf16"] for r in on_paths), None),
        "ivf_scan_i8": (sum(r["ivf_scan_i8"] for r in on_paths), None),
        "adc_scan_i8": (sum(r["adc_scan_i8"] for r in on_paths), None),
    }
    for kind, run in (("bf16", "full_bf16"), ("i8", "full_int8")):
        for p in ("ivf_group_max", "ivf_filter"):
            launches[f"{p}_{kind}"] = (ivf_runs[run][f"{p}_{kind}"],
                                       f"ivf_main_path {run}")
    for p in ("ivf_group_max_bf16", "ivf_filter_bf16"):
        n, path = launches[p]
        launches[p] = (n + recipe["launches"]["ivf"][p],
                       path + " + pipeline_recipe ivf")
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
        "dense_front_stage0": {k: front["stage0_launches"][k]
                               for k in ("adc_group_max", "adc_filter")},
        "dense_front_stage6": {k: front["launches"][k]
                               for k in ("adc_group_max", "adc_filter")},
        "train_stage1": {k: train_run["launches"][k]
                         for k in ("adc_group_max", "adc_filter")},
        "train_stage2": {k: jpq_run["launches"][k]
                         for k in ("adc_group_max", "adc_filter")},
        "ivf_balanced": {k: balanced["launches"][k]
                         for k in ("adc_group_max", "adc_filter")},
        "ivf_decoded_main_path": {k: decoded["launches"][k]
                                  for k in ("adc_group_max", "adc_filter")},
        "ivf_decoded_at_scale": {k: decoded["scale_launches"][k]
                                 for k in ("adc_group_max", "adc_filter")},
        "run_ivf_sweep": {lut: {k: r[k] for k in ("adc_group_max",
                                                  "adc_filter")}
                          for lut, r in sweep.items()},
        "data_parallel": {k: parallel["launches"][k]
                          for k in ("adc_group_max", "adc_filter")},
    }
    ivf_elsewhere = {  # launches of the IVF passes outside ivf_main_path
        "ivf_scale": {lut: r["launches"] for lut, r in ivf_scale.items()},
        "ivf_balanced": balanced["launches"],
        "ivf_decoded_at_scale": decoded["scale_launches"],
        "run_ivf_sweep": sweep,
        "data_parallel": parallel["launches"],
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
            entry["launches_by_path"] = {
                "main_path": main_path["launches"][name],
                "heldout_m12": held_out["launches"][name],
                "heldout_m12_opq": held_out_opq["launches"][name],
                "pipeline_recipe_flat": recipe["launches"]["flat"][name],
                "pipeline_recipe_ivf_spill": recipe["launches"]["ivf"][name]}
            entry["launches_elsewhere"] = {
                k: v for k, v in elsewhere.items()}
            p = "pass1" if name == "adc_group_max" else "pass2"
            entry["train_stage2_ms"] = jpq_run["pass_ms"][p]
            entry["train_stage2_bound_ms"] = jpq_run["bounds"][p][0]
            entry["train_stage2_bound_by"] = jpq_run["bounds"][p][1]
            entry["train_stage2_shape"] = jpq_run["shape"]
        for k in ("ivf_scale_ms", "ivf_scale_bound_ms", "ivf_scale_bound_by"):
            if k in t:
                entry[k] = t[k]
        if name in ("ivf_group_max_bf16", "ivf_filter_bf16"):
            entry["launches_by_path"] = {
                "ivf_main_path": ivf_runs["full_bf16"][name],
                "pipeline_recipe_ivf": recipe["launches"]["ivf"][name]}
        if name.startswith(("ivf_group_max", "ivf_filter")):
            entry["launches_elsewhere"] = {
                path: ({sub: r[name] for sub, r in runs.items()}
                       if path in ("ivf_scale", "run_ivf_sweep") else runs[name])
                for path, runs in ivf_elsewhere.items()}
        line.append(entry)
    print(json.dumps({"kernels": line}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
