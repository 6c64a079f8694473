"""Time one stage-1 train step at the reference's production scale on the
card: the port's counterpart of recipes/bench_stage1_scale.py, with its
flags, defaults, batch and hyperparameters.

The reference's stage-1 global batch is 4096 queries with 1 positive and
11 hard negatives each, 49,152 encoded docs a step, through GradCache
chunking (examples/tas-balanced/repconc/7_run_conc_train.sh:15-20). One
step here is that whole batch on one card: bert-base encoders forward and
backward in chunks of --cache_chunk under torch.utils.checkpoint, the
Sinkhorn-constrained quantization of the 49k docs at M=48, the contrastive
and MSE losses, and the two optimizer groups (train/stage1.py). The
encoder runs in --dtype (bfloat16 by default: fp32 master params, bf16
activations, models/transformer.py).

The JAX script's --analyze (an ahead-of-time XLA compile and its HBM
analysis) has no meaning here: the port runs eagerly, and the peak device
memory of the steps is read with torch.cuda.max_memory_allocated instead.

    python -m repconc_tpu_torch.recipes.bench_stage1_scale [--batch 4096]
        [--negs 11] [--cache_chunk 128] [--dtype bfloat16] [--steps 3]

Prints one JSON line: the step times (host clock around each step, which
ends in a device sync), queries/s and docs/s at the median step, peak
memory, the step's split (encoder forward + backward, constrained encode,
decode + losses, optimizer; CUDA events) and the step's bound: its matmul
FLOPs over the card's dense rate for --dtype.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Dict

import numpy as np

H100_BF16_FLOPS = 989e12   # dense bf16 tensor cores, H100 SXM data sheet
H100_FP32_FLOPS = 67e12    # fp32 outside the tensor cores


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--negs", type=int, default=11)
    ap.add_argument("--cache_chunk", type=int, default=128)
    ap.add_argument("--query_len", type=int, default=16)
    ap.add_argument("--doc_len", type=int, default=128)
    ap.add_argument("--M", type=int, default=48)
    ap.add_argument("--dtype", default="bfloat16",
                    help="encoder activation dtype (bfloat16|float32)")
    ap.add_argument("--steps", type=int, default=3,
                    help="steps after the first (warm-up) one")
    ap.add_argument("--device", default="cuda")
    return ap


def make_batch(B: int, negs: int, query_len: int, doc_len: int,
               vocab_size: int) -> Dict[str, np.ndarray]:
    """The JAX bench's batch (bench_stage1_scale.py:69-89), drawn from
    np.random.default_rng(0) in the same order."""
    n_docs = B * (1 + negs)
    rng = np.random.default_rng(0)

    def tok(n, L):
        ids = rng.integers(5, vocab_size, size=(n, L)).astype(np.int32)
        return ids, np.ones((n, L), np.int32)

    q_ids, q_mask = tok(B, query_len)
    p_ids, p_mask = tok(B, doc_len)
    n_ids, n_mask = tok(B * negs, doc_len)
    positives = np.full((B, 4), -1, np.int32)
    positives[:, 0] = np.arange(B)
    return {
        "query_input_ids": q_ids, "query_attention_mask": q_mask,
        "pos_input_ids": p_ids, "pos_attention_mask": p_mask,
        "neg_input_ids": n_ids, "neg_attention_mask": n_mask,
        "qids": np.arange(B, dtype=np.int32),
        "pos_docids": np.arange(B, dtype=np.int32),
        "neg_docids": rng.integers(B, 10 * n_docs,
                                   size=(B * negs,)).astype(np.int32),
        "query_positives": positives,
    }


def step_flops(cfg, n_queries: int, query_len: int, n_docs: int,
               doc_len: int) -> float:
    """Matmul FLOPs of one GradCache step: four forwards' worth (the
    no-grad forward, the recompute and a backward of two) of the encoder
    over every token. A token's forward takes 2 (4 H^2 + 2 H I) per layer
    in its Dense layers and 4 L H in attention (scores and context)."""
    H, I, layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers

    def forward(tokens, L):
        return tokens * layers * (2 * (4 * H * H + 2 * H * I) + 4 * L * H)

    return 4 * (forward(n_queries * query_len, query_len)
                + forward(n_docs * doc_len, doc_len))


def step_split_ms(model, hp, tx, batch, seeds, reps: int = 3):
    """One stage-1 step cut into its parts, each timed with CUDA events
    (median of `reps` steps): the encoder's forward and backward, the
    constrained encode (Sinkhorn), decode + loss (forward and backward) and
    the optimizer. The parts are train/stage1.py::loss_fn's, with the
    encoder's backward run from the gradients of its outputs. Returns the
    parts' times and the last step's losses (loss, contrastive_loss,
    mse_loss)."""
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
        contrastive = losses.contrastive_loss(
            q_leaf, losses.straight_through(quantized, d_leaf), mask,
            config.MCQ_M)
        mse = losses.mse_loss(quantized, d_leaf)
        loss = contrastive + hp.mse_loss_weight * mse
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
    return ({k: statistics.median(v) for k, v in parts.items()},
            {"loss": float(loss.detach()),
             "contrastive_loss": float(contrastive.detach()),
             "mse_loss": float(mse.detach())})


def run(batch: int = 4096, negs: int = 11, cache_chunk: int = 128,
        query_len: int = 16, doc_len: int = 128, M: int = 48,
        dtype: str = "bfloat16", steps: int = 3, device="cuda",
        warmup_batch: int = None) -> Dict:
    """Build the bert-base model (seeded random weights) and the batch on
    `device`, take one warm-up step and `steps` timed ones; returns the
    numbers main() prints, with the metrics of the last step, and the
    model. On a card the last timed step is step_split_ms's: the same work
    (loss_fn's parts and the optimizer), timed by the host clock around
    it, as the others, and by CUDA events between its parts; the metrics
    are then its losses. Peak memory and the split are read on a card only
    (None on the CPU, where the times are the CPU's). `warmup_batch`: the
    warm-up step takes the bench's batch of that many queries instead (the
    same GradCache chunk shapes, a fraction of the time); first_step_s is
    then that step's."""
    import torch

    from repconc_tpu_torch.core.config import EncoderConfig, RepConcConfig
    from repconc_tpu_torch.core.device import resolve_device
    from repconc_tpu_torch.models.repconc_model import (RepConcModel,
                                                        init_random_)
    from repconc_tpu_torch.train import stage1

    dev = resolve_device(device)
    enc = EncoderConfig(dtype=dtype)  # bert-base architecture defaults
    cfg = RepConcConfig(encoder=enc, MCQ_M=M, MCQ_K=256, sk_epsilon=0.003,
                        sk_iters=100)
    model = init_random_(RepConcModel(cfg),
                         torch.Generator().manual_seed(0)).to(dev)
    hp = stage1.Stage1Hparams(cache_chunk_size=cache_chunk, total_steps=10000,
                              negative_per_query=negs, mse_loss_weight=1e-4,
                              temperature=1.0)
    tx = stage1.make_optimizer(hp, model)
    step_fn = stage1.make_train_step(model, hp, tx)
    host = make_batch(batch, negs, query_len, doc_len, enc.vocab_size)
    dev_batch = {k: torch.as_tensor(v).to(dev) for k, v in host.items()}
    seeds = torch.Generator().manual_seed(0)  # dropout on, as in JAX's step
    n_docs = batch * (1 + negs)

    def timed_step(b=dev_batch):
        t0 = time.perf_counter()
        metrics = step_fn(b, seeds)
        out = {k: float(v) for k, v in metrics.items()}  # syncs the device
        return time.perf_counter() - t0, out

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    if warmup_batch:
        first_s, metrics = timed_step({
            k: torch.as_tensor(v).to(dev) for k, v in make_batch(
                warmup_batch, negs, query_len, doc_len,
                enc.vocab_size).items()})
    else:
        first_s, metrics = timed_step()
    times, split = [], None
    for i in range(steps):
        if on_card and i == steps - 1:
            t0 = time.perf_counter()
            split, metrics = step_split_ms(model, hp, tx, dev_batch, seeds,
                                           reps=1)
            times.append(time.perf_counter() - t0)  # the events synced
        else:
            dt, metrics = timed_step()
            times.append(dt)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 if on_card else None
    step_s = statistics.median(times) if times else first_s
    flops = step_flops(enc, batch, query_len, n_docs, doc_len)
    rate = H100_BF16_FLOPS if dtype == "bfloat16" else H100_FP32_FLOPS
    return {
        "device": (torch.cuda.get_device_name(dev) if on_card else "cpu"),
        "batch": batch, "negs": negs, "docs_per_step": n_docs,
        "cache_chunk": cache_chunk, "query_len": query_len,
        "warmup_batch": warmup_batch or batch,
        "doc_len": doc_len, "M": M, "dtype": dtype,
        "first_step_s": first_s, "step_s": times, "step_ms": step_s * 1e3,
        "queries_per_s": batch / step_s, "docs_per_s": n_docs / step_s,
        "peak_memory_gb": peak, "split_ms": split,
        "step_flops": flops, "bound_ms": flops / rate * 1e3,
        "bound_fp32_ms": flops / H100_FP32_FLOPS * 1e3,
        "metrics": metrics, "model": model}


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = run(batch=args.batch, negs=args.negs, cache_chunk=args.cache_chunk,
              query_len=args.query_len, doc_len=args.doc_len, M=args.M,
              dtype=args.dtype, steps=args.steps, device=args.device)
    out.pop("model")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
