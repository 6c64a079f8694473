"""Stage-1 RepCONC joint training CLI on the port (counterpart of
repconc_tpu/cli/run_train_conc.py, pipeline stage 7; reference:
train/run_train_conc.py).

  python -m repconc_tpu_torch.cli.run_train_conc \\
      --model_name_or_path <warmup_model_dir> --output_dir <out> \\
      --qrel_path ... --query_path ... --corpus_path ... \\
      --valid_qrel_path ... --valid_query_path ... --valid_corpus_path ... \\
      [--device cuda|cpu]

The flags are the JAX CLI's, plus --device (default cuda: without a card it
raises; the CPU runs only when asked). It writes the JAX package's layout:
output_dir/best and output_dir/final are model dirs that either package
loads; output_dir/checkpoint holds the port's train state.
"""
from __future__ import annotations

import argparse
import logging

from repconc_tpu_torch.core.logging_utils import setup_logging

logger = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser()
    # model
    parser.add_argument("--model_name_or_path", required=True,
                        help="warmup RepCONC model dir")
    parser.add_argument("--adapter", default=None)
    parser.add_argument("--sk_epsilon", type=float, default=None)
    parser.add_argument("--sk_iters", type=int, default=None)
    parser.add_argument("--not_use_constraint", action="store_true")
    # data
    parser.add_argument("--qrel_path", required=True)
    parser.add_argument("--query_path", required=True)
    parser.add_argument("--corpus_path", required=True)
    parser.add_argument("--valid_qrel_path", default=None)
    parser.add_argument("--valid_query_path", default=None)
    parser.add_argument("--valid_corpus_path", default=None)
    parser.add_argument("--max_query_len", type=int, default=16)
    parser.add_argument("--max_doc_len", type=int, default=128)
    parser.add_argument("--negative", default="random",
                        help="inbatch | random | path to hard-neg json")
    parser.add_argument("--negative_per_query", type=int, default=1)
    parser.add_argument("--max_positives", type=int, default=8,
                        help="padded per-query judged-positives capacity for "
                             "the false-negative mask; raise to the "
                             "dataset's max qrels length for exact mask "
                             "semantics with densely-judged qrels")
    # training
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--per_device_train_batch_size", type=int, default=64,
                        help="global batch of queries")
    parser.add_argument("--learning_rate", type=float, default=2e-5)
    parser.add_argument("--centroid_learning_rate", type=float, default=5e-4)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--warmup_steps", type=int, default=0)
    parser.add_argument("--max_steps", type=int, default=10000)
    parser.add_argument("--num_train_epochs", type=float, default=None)
    parser.add_argument("--temperature", type=float, default=1.0)
    parser.add_argument("--mse_loss_weight", type=float, default=0.0)
    parser.add_argument("--dynamic_topk_hard_negative", type=int, default=None)
    parser.add_argument("--cache_chunk_size", type=int, default=-1)
    parser.add_argument("--logging_steps", type=int, default=20)
    parser.add_argument("--eval_steps", type=int, default=0)
    parser.add_argument("--save_steps", type=int, default=0)
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--data_parallel", action="store_true",
                        help="train over the ranks of the process group (one "
                             "process per GPU); the batch size is global")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging()

    from repconc_tpu_torch.core.device import resolve_device
    from repconc_tpu_torch.core.mesh import train_mesh
    from repconc_tpu_torch.eval.run_io import load_corpus, load_queries
    from repconc_tpu_torch.eval.trec import parse_qrels
    from repconc_tpu_torch.models import repconc_model
    from repconc_tpu_torch.models.adapters import load_adapter_tokenizer
    from repconc_tpu_torch.train import stage1
    from repconc_tpu_torch.train.data import (FinetuneCollator, QDRelDataset,
                                              batch_iterator)

    mesh = (train_mesh(args.device, args.per_device_train_batch_size)
            if args.data_parallel else None)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    model = repconc_model.from_pretrained(args.model_name_or_path, device=dev)
    config = model.config
    if args.sk_epsilon is not None:
        config.sk_epsilon = args.sk_epsilon
    if args.sk_iters is not None:
        config.sk_iters = args.sk_iters
    tokenizer = load_adapter_tokenizer(
        args.model_name_or_path, args.adapter or config.encoder.model_type)

    if args.negative == "inbatch" and args.negative_per_query != 0:
        # inbatch carries no explicit negatives (the dataset asserts
        # negative_per_query == 0); reconcile instead of crashing
        logger.info("--negative inbatch: forcing --negative_per_query 0 "
                    "(was %d)", args.negative_per_query)
        args.negative_per_query = 0
    dataset = QDRelDataset(
        args.qrel_path, args.query_path, args.corpus_path,
        negative=args.negative, negative_per_query=args.negative_per_query,
        sep_token=tokenizer.sep_token or "[SEP]")
    collator = FinetuneCollator(tokenizer, args.max_query_len, args.max_doc_len,
                                max_positives=args.max_positives)

    total_steps = args.max_steps
    if args.num_train_epochs is not None:
        # max(1, ...): a dataset smaller than the batch would floor to 0
        # steps and the run would exit "successfully" having trained nothing
        steps_per_epoch = max(1, len(dataset)
                              // args.per_device_train_batch_size)
        total_steps = max(1, int(args.num_train_epochs * steps_per_epoch))

    hp = stage1.Stage1Hparams(
        learning_rate=args.learning_rate,
        centroid_learning_rate=args.centroid_learning_rate,
        weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps,
        total_steps=total_steps,
        temperature=args.temperature,
        mse_loss_weight=args.mse_loss_weight,
        negative_per_query=args.negative_per_query,
        dynamic_topk_hard_negative=args.dynamic_topk_hard_negative,
        use_constraint=not args.not_use_constraint,
        cache_chunk_size=args.cache_chunk_size,
        seed=args.seed,
        logging_steps=args.logging_steps,
        eval_steps=args.eval_steps,
        save_steps=args.save_steps,
    )

    valid_set = None
    if args.valid_qrel_path:
        valid_set = (
            load_corpus(args.valid_corpus_path, tokenizer.sep_token or "[SEP]"),
            load_queries(args.valid_query_path),
            parse_qrels(args.valid_qrel_path),
        )

    batches = batch_iterator(dataset, collator, args.per_device_train_batch_size,
                             seed=args.seed)
    out = stage1.train(model, batches, hp, args.output_dir,
                       tokenizer=tokenizer, valid_set=valid_set, device=dev,
                       mesh=mesh)
    logger.info("finished at step %d (best %.5f)", out["step"], out["best_metric"])
    return out


if __name__ == "__main__":
    main()
