"""Stage-2 JPQ training CLI on the port (counterpart of
repconc_tpu/cli/run_train_jpq.py, pipeline stage 9; reference:
train/run_train_jpq.py). Trains the query encoder and the centroids
against the frozen code index of stage 8 (or of the warm-up).

  python -m repconc_tpu_torch.cli.run_train_jpq \\
      --model_name_or_path <stage-1 or warm-up model dir> \\
      --index_dir <dir with codes.npy + corpus_ids.npy> \\
      --qrel_path ... --query_path ... --output_dir <out> \\
      [--valid_qrel_path ... --valid_query_path ...] [--device cuda|cpu]

The flags are the JAX CLI's, plus --device (default cuda: without a card
it raises; the CPU runs only when asked). On the card every step's
hard-negative search is K1's two passes. --index_dir is the corpus cache
that `run_repconc_eval --out_corpus_dir` writes in either package. The
output layout is the JAX package's: output_dir/best and output_dir/final
are model dirs that either package loads; output_dir/checkpoint holds the
port's train state.
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from repconc_tpu_torch.core.logging_utils import setup_logging

logger = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name_or_path", required=True,
                        help="stage-1 or warmup RepCONC model dir")
    parser.add_argument("--adapter", default=None)
    parser.add_argument("--index_dir", required=True,
                        help="dir with codes.npy + corpus_ids.npy")
    parser.add_argument("--qrel_path", required=True)
    parser.add_argument("--query_path", required=True)
    parser.add_argument("--valid_qrel_path", default=None)
    parser.add_argument("--valid_query_path", default=None)
    parser.add_argument("--max_query_len", type=int, default=32)
    parser.add_argument("--max_positives", type=int, default=8,
                        help="padded judged-positives capacity for the "
                             "retrieved-positive mask")
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--per_device_train_batch_size", type=int, default=128)
    parser.add_argument("--learning_rate", type=float, default=5e-6)
    parser.add_argument("--centroid_learning_rate", type=float, default=2e-4)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--warmup_steps", type=int, default=0)
    parser.add_argument("--max_steps", type=int, default=10000)
    parser.add_argument("--num_train_epochs", type=float, default=None)
    parser.add_argument("--dynamic_topk_negative", type=int, default=200)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--data_parallel", action="store_true",
                        help="not ported yet: raises")
    parser.add_argument("--logging_steps", type=int, default=20)
    parser.add_argument("--eval_steps", type=int, default=0)
    parser.add_argument("--save_steps", type=int, default=0)
    parser.add_argument("--seed", type=int, default=2023)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging()
    if args.data_parallel:
        raise NotImplementedError(
            "--data_parallel is not ported yet (ROADMAP.md, Queue 1 item 10 "
            "(multi-GPU))")

    from repconc_tpu_torch.core.device import resolve_device
    from repconc_tpu_torch.eval.run_io import load_queries
    from repconc_tpu_torch.eval.trec import parse_qrels
    from repconc_tpu_torch.models import repconc_model
    from repconc_tpu_torch.models.adapters import load_adapter_tokenizer
    from repconc_tpu_torch.train import stage2
    from repconc_tpu_torch.train.data import (QueryCollator, QueryDataset,
                                              batch_iterator)

    dev = resolve_device(args.device)
    model = repconc_model.from_pretrained(args.model_name_or_path, device=dev)
    tokenizer = load_adapter_tokenizer(
        args.model_name_or_path, args.adapter or model.config.encoder.model_type)

    codes = np.load(os.path.join(args.index_dir, "codes.npy"))
    corpus_ids = np.load(os.path.join(args.index_dir, "corpus_ids.npy"))

    dataset = QueryDataset(args.qrel_path, args.query_path, corpus_ids)
    collator = QueryCollator(tokenizer, args.max_query_len,
                             max_positives=args.max_positives)

    total_steps = args.max_steps
    if args.num_train_epochs is not None:
        # max(1, ...): a dataset smaller than the batch would floor to 0
        # steps and the run would exit "successfully" having trained nothing
        steps_per_epoch = max(1, len(dataset)
                              // args.per_device_train_batch_size)
        total_steps = max(1, int(args.num_train_epochs * steps_per_epoch))

    hp = stage2.Stage2Hparams(
        learning_rate=args.learning_rate,
        centroid_learning_rate=args.centroid_learning_rate,
        weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps,
        total_steps=total_steps,
        dynamic_topk_negative=args.dynamic_topk_negative,
        temperature=args.temperature,
        seed=args.seed,
        logging_steps=args.logging_steps,
        eval_steps=args.eval_steps,
        save_steps=args.save_steps,
    )

    valid_set = None
    if args.valid_qrel_path:
        valid_set = (corpus_ids, load_queries(args.valid_query_path),
                     parse_qrels(args.valid_qrel_path))

    batches = batch_iterator(dataset, collator, args.per_device_train_batch_size,
                             seed=args.seed)
    out = stage2.train(model, codes, batches, hp, args.output_dir,
                       tokenizer=tokenizer, valid_set=valid_set, device=dev)
    logger.info("finished at step %d (best %.5f)", out["step"], out["best_metric"])
    return out


if __name__ == "__main__":
    main()
