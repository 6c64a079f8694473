"""Stage-1 RepCONC joint training: encoders + centroids under the constraint.

Counterpart of repconc_tpu/train/stage1.py (the reference's
RepCONCFinetuner, finetune_repconc.py:225-613), on one device:

* GradCache (finetune_repconc.py:278-396) is `encode_chunked`: chunks of
  the batch encode under torch.utils.checkpoint, so the backward recomputes
  each chunk's activations instead of storing them. Dropout draws from a
  generator seeded per chunk, so the recompute draws the forward's masks.
* The surrogate trick (gradients into both the continuous and the quantized
  paths, finetune_repconc.py:368-373) is quant/losses.py::straight_through.
* The optimizer is the JAX package's optax chain: one global clip over
  every parameter, the rotation's gradient included, then AdamW with the
  HF decay mask for the encoder, Adam at centroid_learning_rate for the
  centroids, and no update of the rotation (`Stage1Optimizer`).

The JAX package's cross-device batch (a mesh, DCN processes) is ROADMAP.md
Queue 1 item 10. Its train state is a flax msgpack or an orbax checkpoint;
the port's is a torch.save file (`save_train_state`): a deviation by
design, listed in ROADMAP.md Queue 3.
"""
from __future__ import annotations

import json
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repconc_tpu_torch.core.config import METRIC_CENTROID_COS
from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.eval import pipeline
from repconc_tpu_torch.models import repconc_model
from repconc_tpu_torch.models.convert import param_table
from repconc_tpu_torch.quant import codebook, losses

logger = logging.getLogger(__name__)

STATE_NAME = "train_state.pt"


@dataclass
class Stage1Hparams:
    """Mirrors RepCONCFinetuneArguments (finetune_repconc.py:44-58)."""

    learning_rate: float = 2e-5
    centroid_learning_rate: float = 5e-4
    weight_decay: float = 0.01
    warmup_steps: int = 0
    total_steps: int = 10000
    temperature: float = 1.0
    mse_loss_weight: float = 0.0
    negative_per_query: int = 1
    dynamic_topk_hard_negative: Optional[int] = None
    use_constraint: bool = True
    quantize: bool = True               # False: dense pre-training (stage 0)
    cache_chunk_size: int = -1          # -1: no chunking (plain large batch)
    max_grad_norm: float = 1.0
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    seed: int = 2022
    logging_steps: int = 20
    eval_steps: int = 0                 # 0: no in-training eval
    save_steps: int = 0


def _decay_mask(model) -> Dict[str, bool]:
    """HF-style: no weight decay for biases and LayerNorm parameters
    (finetune_repconc.py:485-502). Each torch parameter is labelled by its
    flax path (models/convert.py::param_table), as the JAX package labels
    its tree: a LayerNorm's torch `weight` is flax's `*_ln/scale`."""
    def label(path):
        if "bias" in path:
            return False
        return not any(k.endswith("_ln") or k == "scale" for k in path)

    return {name: label(path) for path, name, _ in param_table(model.config)}


def _lr_factor(count: int, warmup_steps: int, total_steps: int) -> float:
    """The share of the peak rate at update `count` (0-based) of optax's
    join_schedules([linear 0 -> peak over max(warmup, 1) updates,
    linear peak -> 0 over max(total - warmup, 1) updates], [warmup]):
    update k takes lr(k), so with no warm-up the first takes the peak."""
    if count < warmup_steps:
        return count / max(warmup_steps, 1)
    span = max(total_steps - warmup_steps, 1)
    return 1.0 - min(count - warmup_steps, span) / span


class Stage1Optimizer:
    """optax.chain(clip_by_global_norm, multi_transform({"base": adamw with
    the decay mask, "centroid": adam, "frozen": set_to_zero})) of
    repconc_tpu/train/stage1.py:83-110 over a RepConcModel.

    The clip's norm takes every parameter's gradient, the rotation's too:
    in the JAX package the rotation is a leaf of the tree that the clip sees
    before set_to_zero drops its update. Only the rotation is left out of
    the AdamW groups, so it never moves."""

    def __init__(self, hp: Stage1Hparams, model):
        self.hp = hp
        decays = _decay_mask(model)
        named = dict(model.named_parameters())
        encoder = [n for n in named if n.startswith("encoder.")]
        self.leaves = list(named.values())
        groups = [
            {"params": [named[n] for n in encoder if decays[n]],
             "weight_decay": hp.weight_decay, "peak_lr": hp.learning_rate},
            {"params": [named[n] for n in encoder if not decays[n]],
             "weight_decay": 0.0, "peak_lr": hp.learning_rate},
            {"params": [named["centroids"]], "weight_decay": 0.0,
             "peak_lr": hp.centroid_learning_rate},
        ]
        self.optimizer = torch.optim.AdamW(
            groups, lr=0.0, betas=(0.9, hp.adam_beta2), eps=hp.adam_epsilon)
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.leaves:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, update, count; returns the global norm before the clip
        (optax.global_norm of the gradients, the metric `grad_norm`)."""
        hp = self.hp
        for p in self.leaves:
            if p.grad is None:  # optax moves every leaf, a zero gradient's too
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.leaves]
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        # optax: unchanged below max_norm, else (g / norm) * max_norm; not
        # torch.nn.utils.clip_grad_norm_, which scales by max / (norm + 1e-6)
        keep = norm < hp.max_grad_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * hp.max_grad_norm))
        factor = _lr_factor(self.count, hp.warmup_steps, hp.total_steps)
        for group in self.optimizer.param_groups:
            group["lr"] = group["peak_lr"] * factor
        self.optimizer.step()
        self.count += 1
        return norm

    def state_dict(self) -> Dict[str, Any]:
        return {"optimizer": self.optimizer.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.count = state["count"]


def make_optimizer(hp: Stage1Hparams, model) -> Stage1Optimizer:
    return Stage1Optimizer(hp, model)


def draw_seeds(seeds: torch.Generator, n: int) -> List[int]:
    """n dropout seeds from the host generator `seeds`."""
    return torch.randint(0, 2 ** 62, (n,), generator=seeds).tolist()


def encode_chunked(model, input_ids, attention_mask, chunk_size: int,
                   seeds: Optional[torch.Generator] = None) -> torch.Tensor:
    """GradCache as torch.utils.checkpoint (stage1.py:113-147): chunks of
    `chunk_size` rows (rounded down to a divisor of the batch) encode under
    checkpoint, so the backward recomputes their activations.

    seeds: a host generator; each chunk draws from it the seed of its own
    dropout generator (None: no dropout). The recompute rebuilds the
    generator from that seed, so it draws the forward's masks; the global
    RNG plays no part (preserve_rng_state=False)."""
    def enc(ids, mask, seed):
        gen = (None if seed is None
               else torch.Generator(device=ids.device).manual_seed(seed))
        return model.encode_continuous(ids, mask, gen)

    B = input_ids.shape[0]
    if chunk_size <= 0 or B <= chunk_size:
        seed = None if seeds is None else draw_seeds(seeds, 1)[0]
        return enc(input_ids, attention_mask, seed)
    # a non-dividing chunk must not silently disable the chunking
    chunk_size = codebook.round_to_divisor(B, chunk_size)
    nc = B // chunk_size
    chunk_seeds = [None] * nc if seeds is None else draw_seeds(seeds, nc)
    outs = [checkpoint(enc, input_ids[i * chunk_size:(i + 1) * chunk_size],
                       attention_mask[i * chunk_size:(i + 1) * chunk_size],
                       seed, use_reentrant=False, preserve_rng_state=False)
            for i, seed in enumerate(chunk_seeds)]
    return torch.cat(outs, 0)


def loss_fn(model, hp: Stage1Hparams, batch: Dict[str, torch.Tensor],
            seeds: Optional[torch.Generator] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The step's loss (stage1.py:157-204): contrastive over the batch's
    queries and docs, on the constrained quantized docs, plus the weighted
    reconstruction MSE. Returns (total, metrics)."""
    config = model.config
    mcc = config.similarity_metric == METRIC_CENTROID_COS

    def enc(key):
        return encode_chunked(model, batch[f"{key}_input_ids"],
                              batch[f"{key}_attention_mask"],
                              hp.cache_chunk_size, seeds)

    q_embeds = enc("query")
    pos_embeds = enc("pos")
    if "neg_input_ids" in batch:
        doc_embeds = torch.cat([pos_embeds, enc("neg")], 0)
        doc_ids = torch.cat([batch["pos_docids"], batch["neg_docids"]])
    else:
        doc_embeds, doc_ids = pos_embeds, batch["pos_docids"]

    if hp.quantize:
        codes = codebook.encode(doc_embeds, model.centroids,
                                use_constraint=hp.use_constraint,
                                sk_epsilon=config.sk_epsilon,
                                sk_iters=config.sk_iters)
        quantized = codebook.decode(codes, model.centroids)
        doc_rep = losses.straight_through(quantized, doc_embeds)
    else:  # dense pre-training (stage 0): no codebook in the graph
        quantized = doc_rep = doc_embeds

    neg_mask = (losses.false_negative_mask(batch["qids"], doc_ids,
                                           batch["query_positives"])
                | losses.duplicate_negative_mask(batch["qids"], doc_ids))
    co_loss = losses.contrastive_loss(
        q_embeds, doc_rep, neg_mask, config.MCQ_M, metric_centroid_cos=mcc,
        temperature=hp.temperature,
        dynamic_topk_hard_negative=hp.dynamic_topk_hard_negative)
    m_loss = losses.mse_loss(quantized, doc_embeds)
    total = co_loss + hp.mse_loss_weight * m_loss
    return total, {"loss": total.detach(), "contrastive_loss": co_loss.detach(),
                   "mse_loss": m_loss.detach()}


def make_train_step(model, hp: Stage1Hparams, tx: Stage1Optimizer):
    """The step (stage1.py:150-215): loss, backward, clip and update, then
    the CENTROID_COS renormalisation (RepCONC_Norm_Centroid_Callback,
    finetune_repconc.py:216-222). `train_step(batch, seeds)` takes a dict
    of tensors on the model's device and returns the metrics as 0-d
    tensors, `grad_norm` among them; the gradients stay in `.grad`,
    clipped."""
    mcc = model.config.similarity_metric == METRIC_CENTROID_COS

    def train_step(batch, seeds=None):
        tx.zero_grad()
        total, metrics = loss_fn(model, hp, batch, seeds)
        total.backward()
        metrics["grad_norm"] = tx.step()
        if mcc:
            with torch.no_grad():
                model.centroids.copy_(
                    codebook.normalize_centroids(model.centroids))
        return metrics

    return train_step


def make_quant_health_fn(model):
    """test_quantize + eval_balance diagnostics (finetune_repconc.py:
    580-613, stage1.py:218-259): reconstruction RMSE and code balance over
    all M subspaces, with and without the constraint."""
    config = model.config

    @torch.no_grad()
    def fn(input_ids, attention_mask) -> Dict[str, torch.Tensor]:
        doc_embeds = model.encode_continuous(input_ids, attention_mask)
        out = {}
        for prefix, use_constraint in (("wo_conc", False), ("w_conc", True)):
            codes = codebook.encode(doc_embeds, model.centroids,
                                    use_constraint=use_constraint,
                                    sk_epsilon=config.sk_epsilon,
                                    sk_iters=config.sk_iters)
            rec = codebook.decode(codes, model.centroids)
            rmse = ((rec - doc_embeds) ** 2).sum(-1).sqrt().mean()
            counts = F.one_hot(codes, config.MCQ_K).sum(0).float()  # (M, K)
            expected = doc_embeds.shape[0] / config.MCQ_K
            imbalance = (1.0 - counts / expected).abs()
            out[f"{prefix}_rmse"] = rmse
            out[f"{prefix}_avg_imbalance"] = imbalance.mean()
            out[f"{prefix}_max_imbalance"] = imbalance.max()
            out[f"{prefix}_worst_subspace"] = (
                imbalance.amax(1).argmax().float())
        return out

    return fn


# ---------------------------------------------------------------------------
# Host training loop


def save_train_state(path: str, model, tx: Stage1Optimizer,
                     seeds: torch.Generator, step: int, best: float) -> None:
    """Persist the model, the optimizer and the dropout seed generator for
    resume, plus trainer_meta.json as the JAX package writes it. Both files
    are written atomically: a crash mid-save must never leave a truncated
    state where the previous resumable one stood."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_NAME)
    torch.save({"model": model.state_dict(), "optimizer": tx.state_dict(),
                "seeds": seeds.get_state()}, target + ".tmp")
    os.replace(target + ".tmp", target)
    meta_target = os.path.join(path, "trainer_meta.json")
    with open(meta_target + ".tmp", "w") as f:
        json.dump({"step": step, "best_metric": best, "backend": "torch"}, f)
    os.replace(meta_target + ".tmp", meta_target)


def load_train_state(path: str, model, tx: Stage1Optimizer,
                     seeds: torch.Generator) -> Tuple[int, float]:
    """Restore what save_train_state wrote; returns (step, best)."""
    with open(os.path.join(path, "trainer_meta.json")) as f:
        meta = json.load(f)
    blob = torch.load(os.path.join(path, STATE_NAME), map_location="cpu",
                      weights_only=True)
    model.load_state_dict(blob["model"])
    tx.load_state_dict(blob["optimizer"])
    seeds.set_state(blob["seeds"])
    return meta["step"], meta["best_metric"]


def save_model_dir(path: str, model, tokenizer) -> None:
    """A model dir both packages load, with the tokenizer's files when the
    tokenizer can save them."""
    repconc_model.save_pretrained(path, model)
    if getattr(tokenizer, "save_pretrained", None) is not None:
        tokenizer.save_pretrained(path)


def train(model, batches: Iterator[Dict[str, np.ndarray]], hp: Stage1Hparams,
          output_dir: str, tokenizer=None,
          valid_set: Optional[Tuple[Dict, Dict, Dict]] = None,
          metric_for_best: str = "MRR@10", log_fn=None,
          device="cuda") -> Dict[str, Any]:
    """Run stage-1 training on `device` (stage1.py:315-432). valid_set =
    (corpus, queries, qrels), validated every eval_steps through the flat
    quantized search (on the card, K1's two passes), or with
    hp.quantize=False (stage 0) through the dense flat search.

    Resumes automatically if output_dir holds a train state; an unreadable
    one restarts from step 0. Writes output_dir/checkpoint (the train
    state), best/ (on each better metric_for_best) and final/."""
    dev = resolve_device(device)
    model.to(dev)
    tx = make_optimizer(hp, model)
    seeds = torch.Generator().manual_seed(hp.seed)
    start_step, best = 0, -1.0
    ckpt_dir = os.path.join(output_dir, "checkpoint")
    if os.path.exists(os.path.join(ckpt_dir, "trainer_meta.json")):
        try:
            start_step, best = load_train_state(ckpt_dir, model, tx, seeds)
            logger.info("resumed from step %d (best %.5f)", start_step, best)
        except Exception as e:  # a killed run's state: restart from init
            #                     rather than failing on every retry
            logger.warning("train-state checkpoint unreadable (%s) — "
                           "starting from step 0", e)
            tx = make_optimizer(hp, model)
            seeds = torch.Generator().manual_seed(hp.seed)

    step_fn = make_train_step(model, hp, tx)
    health_fn = make_quant_health_fn(model)
    log = log_fn or (lambda d: logger.info("%s", d))
    history = []
    step = start_step
    for batch in batches:
        if step >= hp.total_steps:
            break
        dev_batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        metrics = step_fn(dev_batch, seeds)
        step += 1
        if hp.logging_steps and step % hp.logging_steps == 0:
            m = {k: float(v) for k, v in metrics.items()}
            if hp.quantize:
                m.update({k: round(float(v), 4) for k, v in health_fn(
                    dev_batch["pos_input_ids"],
                    dev_batch["pos_attention_mask"]).items()})
            m["step"] = step
            history.append(m)
            log(m)
        if hp.eval_steps and valid_set is not None and step % hp.eval_steps == 0:
            # save BEFORE the eval when a save is due at this step, so a run
            # killed during the eval resumes at this step, not before it;
            # resume redoes the eval
            if hp.save_steps and step % hp.save_steps == 0:
                save_train_state(ckpt_dir, model, tx, seeds, step, best)
            corpus, queries, qrels = valid_set
            eval_fn = (pipeline.evaluate_repconc_model if hp.quantize
                       else pipeline.evaluate_dense_model)
            eval_m = eval_fn(model, tokenizer, corpus, queries, qrels,
                             max_seq_length=512, topk=10, device=dev)
            log({"step": step, **{f"eval_{k}": v for k, v in eval_m.items()}})
            score = eval_m.get(metric_for_best, 0.0)
            if score > best:
                best = score
                save_model_dir(os.path.join(output_dir, "best"), model,
                               tokenizer)
        if hp.save_steps and step % hp.save_steps == 0:
            save_train_state(ckpt_dir, model, tx, seeds, step, best)

    save_train_state(ckpt_dir, model, tx, seeds, step, best)
    save_model_dir(os.path.join(output_dir, "final"), model, tokenizer)
    return {"model": model, "step": step, "best_metric": best,
            "history": history}
