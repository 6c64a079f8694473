"""Stage-2 (JPQ-style) training: the query encoder and the centroids
against frozen doc codes.

Counterpart of repconc_tpu/train/stage2.py (the reference's JPQFinetuner,
finetune_jpq.py:142-374), on one device. The index IS (codes, centroids):
the in-step search reads the centroids the optimizer updates, so nothing
is kept in sync. Each step (stage2.py:113-187):

1. encode the queries (trainable; dropout from a seeded generator, as in
   stage 1);
2. search every doc code for the top-k hard negatives with the detached
   queries and the pre-update centroids, outside the autograd graph
   (`retrieve`): on the card K1's two passes (index/cuda_adc.py::adc_topk)
   over the LUT rounded to bf16;
3. decode the negatives and the sampled positive through the centroids,
   so the gradient reaches them;
4. cross-entropy over [positive; negatives] with label 0, the scores
   divided by the temperature only, not by M (finetune_jpq.py:179-188),
   and retrieved judged positives masked with -10000. The reference
   computes that mask and never applies it (finetune_jpq.py:191,231-243);
   the JAX package applies it on purpose, and so does the port.

Deviations by design (ROADMAP.md Queue 3): the in-step search is the exact
top-k by (score DESC, id ASC), where the TPU's kernel branch asked for
recall 0.95 (stage2.py:129-130); a CUDA device takes the kernel at every
N, where the JAX package takes Pallas only off the CPU at N >= 100,000
(stage2.py:92-95). The JAX package's data-parallel mesh is ROADMAP.md
Queue 1 item 10.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repconc_tpu_torch.core.config import METRIC_CENTROID_COS
from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.eval.encode import encode_queries
from repconc_tpu_torch.eval.pipeline import flat_metrics, run_from_topk
from repconc_tpu_torch.index.adc import batch_adc_search, build_lut, plain_topk
from repconc_tpu_torch.index.cuda_adc import CudaADCIndex, adc_topk
from repconc_tpu_torch.quant import codebook
from repconc_tpu_torch.train import stage1

logger = logging.getLogger(__name__)

MASK = 10000.0  # subtracted from the score of a retrieved judged positive


@dataclass
class Stage2Hparams:
    """Mirrors JPQFinetuneArguments (finetune_jpq.py:40-49)."""

    learning_rate: float = 5e-6
    centroid_learning_rate: float = 2e-4
    weight_decay: float = 0.01
    warmup_steps: int = 0
    total_steps: int = 10000
    dynamic_topk_negative: int = 200
    temperature: float = 1.0
    max_grad_norm: float = 1.0
    # None: K1's passes on a CUDA device, the plain fp32 scorer on the CPU;
    # True: the passes everywhere (on the CPU their plain versions, with the
    # bf16 LUT); False: the plain fp32 scorer everywhere
    use_pallas_search: Optional[bool] = None
    seed: int = 2023
    logging_steps: int = 20
    eval_steps: int = 0
    save_steps: int = 0

    def as_stage1(self) -> stage1.Stage1Hparams:
        return stage1.Stage1Hparams(
            learning_rate=self.learning_rate,
            centroid_learning_rate=self.centroid_learning_rate,
            weight_decay=self.weight_decay,
            warmup_steps=self.warmup_steps,
            total_steps=self.total_steps,
            max_grad_norm=self.max_grad_norm,
        )


def takes_kernel(use_pallas_search: Optional[bool], device) -> bool:
    """Whether the in-step search runs K1's two passes (adc_topk) rather
    than the plain fp32 scorer (see Stage2Hparams.use_pallas_search)."""
    if use_pallas_search is None:
        return torch.device(device).type == "cuda"
    return bool(use_pallas_search)


@torch.no_grad()
def retrieve(q_embeds: torch.Tensor, centroids: torch.Tensor,
             codes: torch.Tensor, n_docs: int, topk: int,
             use_kernel: bool) -> torch.Tensor:
    """The dynamic hard negatives (stage2.py:113-137): ids (B, topk) int64
    of the best docs among 0..n_docs-1 for the detached queries and
    centroids. Gradient-free, as the reference searches a detached faiss
    copy (finetune_jpq.py:176). With use_kernel, the LUT is rounded to bf16
    (the TPU kernel's input type) and adc_topk runs: K1's two passes on a
    CUDA tensor, their plain versions on a CPU one."""
    lut = build_lut(q_embeds.detach(), centroids.detach())
    if use_kernel:
        return adc_topk(lut.to(torch.bfloat16).contiguous(), codes, n_docs,
                        topk)[1]
    return plain_topk(lut, codes, n_docs, topk)[1]


def positive_mask(neg_pids: torch.Tensor,
                  positives: torch.Tensor) -> torch.Tensor:
    """(B, k) bool: retrieved docs that are judged positives of their query;
    positives (B, P) is -1 padded (stage2.py:165-170)."""
    positives = positives.long()[:, None, :]
    return ((neg_pids[:, :, None] == positives) & (positives >= 0)).any(-1)


def ranking_loss(q_embeds: torch.Tensor, centroids: torch.Tensor,
                 codes: torch.Tensor, neg_pids: torch.Tensor,
                 batch: Dict[str, torch.Tensor], temperature: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE over [positive; negatives] with label 0 (stage2.py:139-175), the
    docs decoded from their codes through the centroids. Returns (loss,
    the (B, k) mask of retrieved positives)."""
    B, k = neg_pids.shape
    neg = codebook.decode(codes[neg_pids.reshape(-1)],
                          centroids).reshape(B, k, -1)
    pos = codebook.decode(codes[batch["pos_docids"].long()], centroids)
    neg_scores = torch.einsum("bd,bkd->bk", q_embeds, neg) / temperature
    pos_scores = (q_embeds * pos).sum(-1, keepdim=True) / temperature
    is_pos = positive_mask(neg_pids, batch["query_positives"])
    neg_scores = neg_scores - MASK * is_pos.to(neg_scores.dtype)
    logits = torch.cat([pos_scores, neg_scores], 1)
    loss = (torch.logsumexp(logits, -1) - logits[:, 0]).mean()
    return loss, is_pos


def loss_fn(model, hp: Stage2Hparams, batch: Dict[str, torch.Tensor],
            codes: torch.Tensor, n_docs: int, use_kernel: bool,
            seeds: Optional[torch.Generator] = None):
    """The step's loss. Returns (loss, metrics, aux); aux holds what the
    step searched and masked: the detached query embeddings `q_embeds`, the
    retrieved ids `neg_pids` and the mask `masked`."""
    q_embeds = stage1.encode_chunked(model, batch["query_input_ids"],
                                     batch["query_attention_mask"], -1, seeds)
    neg_pids = retrieve(q_embeds, model.centroids, codes, n_docs,
                        hp.dynamic_topk_negative, use_kernel)
    loss, is_pos = ranking_loss(q_embeds, model.centroids, codes, neg_pids,
                                batch, hp.temperature)
    return loss, {"loss": loss.detach()}, {
        "q_embeds": q_embeds.detach(), "neg_pids": neg_pids, "masked": is_pos}


def make_train_step(model, hp: Stage2Hparams, tx: stage1.Stage1Optimizer,
                    codes: torch.Tensor, n_docs: Optional[int] = None):
    """The step over device-resident uint8 codes (N', M): docs 0..n_docs-1
    are the corpus (default all N'), the rows after them padding, as
    CudaADCIndex holds them. `train_step(batch, seeds)` takes a dict of
    tensors on the model's device and returns the metrics `loss` and
    `grad_norm` (before the clip) as 0-d tensors.

    k > n_docs raises ValueError, as the JAX package's XLA branch does
    (its Pallas branch would draw pad rows as negatives instead)."""
    n_docs = codes.shape[0] if n_docs is None else n_docs
    k = hp.dynamic_topk_negative
    if not 1 <= k <= n_docs:
        raise ValueError(f"dynamic_topk_negative={k} outside [1, {n_docs}] "
                         "(the number of docs)")
    use_kernel = takes_kernel(hp.use_pallas_search, codes.device)
    mcc = model.config.similarity_metric == METRIC_CENTROID_COS

    def train_step(batch, seeds=None):
        tx.zero_grad()
        loss, metrics, _ = loss_fn(model, hp, batch, codes, n_docs,
                                   use_kernel, seeds)
        loss.backward()
        metrics["grad_norm"] = tx.step()
        if mcc:
            with torch.no_grad():
                model.centroids.copy_(
                    codebook.normalize_centroids(model.centroids))
        return metrics

    return train_step


def train(model, codes, batches: Iterator[Dict[str, np.ndarray]],
          hp: Stage2Hparams, output_dir: str, tokenizer=None,
          valid_set: Optional[Tuple[np.ndarray, Dict, Dict]] = None,
          metric_for_best: str = "MRR@10", log_fn=None, mesh=None,
          device="cuda") -> Dict[str, Any]:
    """Run stage-2 training on `device` (stage2.py:192-291). codes: the
    frozen (N, M) uint8 doc codes, host numpy or a tensor; they go to the
    device once, as a CudaADCIndex, which serves every step's search and
    the validation. valid_set = (corpus_ids, queries, qrels), validated
    every eval_steps: the queries encoded at length 64, then the top-10 over
    the frozen codes with the live centroids (on the card K1's two passes,
    on the CPU the fp32 plain scorer, as batch_adc_search dispatches).

    Resumes if output_dir holds a train state; an unreadable one restarts
    from step 0. Writes output_dir/checkpoint (the train state, every
    save_steps and at the end), best/ (on each better metric_for_best) and
    final/."""
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel stage-2 training (mesh=) is not ported yet "
            "(ROADMAP.md, Queue 1 item 10)")
    dev = resolve_device(device)
    model.to(dev)
    tx = stage1.make_optimizer(hp.as_stage1(), model)
    seeds = torch.Generator().manual_seed(hp.seed)
    start_step, best = 0, -1.0
    ckpt_dir = os.path.join(output_dir, "checkpoint")
    if os.path.exists(os.path.join(ckpt_dir, "trainer_meta.json")):
        try:
            start_step, best = stage1.load_train_state(ckpt_dir, model, tx,
                                                       seeds)
            logger.info("resumed from step %d (best %.5f)", start_step, best)
        except Exception as e:  # a killed run's state: restart from init
            logger.warning("train-state checkpoint unreadable (%s) — "
                           "starting from step 0", e)
            tx = stage1.make_optimizer(hp.as_stage1(), model)
            seeds = torch.Generator().manual_seed(hp.seed)

    index = CudaADCIndex(codes, model.centroids.detach(), device=dev)
    step_fn = make_train_step(model, hp, tx, index.codes, index.N)
    log = log_fn or (lambda d: logger.info("%s", d))
    history = []
    step = start_step

    def eval_now():
        cids, queries, qrels = valid_set
        q_embeds, query_ids = encode_queries(queries, model, tokenizer, 64,
                                             batch_size=256, device=dev)
        s, ids = batch_adc_search(
            query_ids, q_embeds, cids, codes,
            model.centroids.detach().cpu().numpy(), topk=10, device=dev,
            searcher=index)
        return flat_metrics(qrels, run_from_topk(query_ids, s, ids), (10,),
                            (10,))

    for batch in batches:
        if step >= hp.total_steps:
            break
        dev_batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        metrics = step_fn(dev_batch, seeds)
        step += 1
        if hp.logging_steps and step % hp.logging_steps == 0:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            history.append(m)
            log(m)
        if hp.eval_steps and valid_set is not None and step % hp.eval_steps == 0:
            eval_m = eval_now()
            log({"step": step, **{f"eval_{k}": v for k, v in eval_m.items()}})
            score = eval_m.get(metric_for_best, 0.0)
            if score > best:
                best = score
                stage1.save_model_dir(os.path.join(output_dir, "best"), model,
                                      tokenizer)
        if hp.save_steps and step % hp.save_steps == 0:
            stage1.save_train_state(ckpt_dir, model, tx, seeds, step, best)

    stage1.save_train_state(ckpt_dir, model, tx, seeds, step, best)
    stage1.save_model_dir(os.path.join(output_dir, "final"), model, tokenizer)
    return {"model": model, "step": step, "best_metric": best,
            "history": history}
