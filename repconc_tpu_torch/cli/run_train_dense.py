"""Stage-0 dense contrastive pre-training on the port (counterpart of
repconc_tpu/cli/run_train_dense.py). The pipeline starts from a trained
dense encoder; this stage makes one: stage-1 training with
Stage1Hparams(quantize=False) (no codebook in the graph; GradCache, the
batch's masks and the optimizer are stage 1's), validated by the exact
flat search (eval/pipeline.py::evaluate_dense_model) and exported as an
HF checkpoint (models/auto.py::save_hf_checkpoint) for stage 2.

  python -m repconc_tpu_torch.cli.run_train_dense \\
      --model_name_or_path <hf_dir> --output_dir <out> \\
      --qrel_path ... --query_path ... --corpus_path ... \\
      --valid_qrel_path ... --valid_query_path ... --valid_corpus_path ... \\
      --pooling mean --similarity_metric METRIC_IP [--device cuda|cpu]

The flags are the JAX CLI's, plus --device (default cuda: without a card it
raises). The trained checkpoint lands in <output_dir>/export_hf, beside
best/, final/ and checkpoint/ as run_train_conc writes them.
"""
from __future__ import annotations

import argparse
import logging
import os

from repconc_tpu_torch.core.logging_utils import setup_logging

logger = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name_or_path", required=True,
                        help="HF dense encoder dir (e.g. random-init bert)")
    parser.add_argument("--adapter", default=None)
    parser.add_argument("--pooling", default="mean", choices=["cls", "mean"])
    parser.add_argument("--similarity_metric", default="METRIC_IP",
                        choices=["METRIC_IP", "METRIC_COS"])
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
                        help="padded per-query positives list driving the "
                             "in-batch false-negative mask; set to the "
                             "dataset's max qrels length for exact mask "
                             "semantics under densely-judged qrels")
    # training
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--per_device_train_batch_size", type=int, default=256)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--warmup_steps", type=int, default=100)
    parser.add_argument("--max_steps", type=int, default=2000)
    parser.add_argument("--temperature", type=float, default=1.0)
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


def export_best(output_dir: str, src_model_dir: str, device) -> str:
    """Write output_dir/export_hf from best/ (the best validation), else
    final/, as an HF dir with src_model_dir's config and tokenizer files.
    Returns its path."""
    from repconc_tpu_torch.models import repconc_model
    from repconc_tpu_torch.models.auto import save_hf_checkpoint

    src = os.path.join(output_dir, "best")
    if not os.path.isdir(src):
        src = os.path.join(output_dir, "final")
    model = repconc_model.from_pretrained(src, device=device)
    export_dir = os.path.join(output_dir, "export_hf")
    save_hf_checkpoint(export_dir, src_model_dir, model.encoder.state_dict(),
                       model.config.encoder,
                       similarity_metric=model.config.similarity_metric)
    return export_dir


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
    # M is a placeholder: with quantize=False no codebook is in the graph
    model = repconc_model.from_dense_encoder(
        args.model_name_or_path, MCQ_M=1,
        similarity_metric=args.similarity_metric, pooling=args.pooling,
        adapter=args.adapter, device=dev)
    tokenizer = load_adapter_tokenizer(
        args.model_name_or_path, args.adapter or model.config.encoder.model_type)

    if args.negative == "inbatch" and args.negative_per_query != 0:
        # inbatch carries no explicit negatives (the dataset asserts
        # negative_per_query == 0); reconcile instead of crashing
        logger.info("--negative inbatch: forcing --negative_per_query 0 "
                    "(was %d)", args.negative_per_query)
        args.negative_per_query = 0
    dataset = QDRelDataset(
        args.qrel_path, args.query_path, args.corpus_path,
        negative=args.negative, negative_per_query=args.negative_per_query,
        sep_token=tokenizer.sep_token or "[SEP]",
        max_positives=args.max_positives)
    collator = FinetuneCollator(tokenizer, args.max_query_len, args.max_doc_len,
                                max_positives=args.max_positives)
    hp = stage1.Stage1Hparams(
        learning_rate=args.learning_rate,
        centroid_learning_rate=0.0,
        weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps,
        total_steps=args.max_steps,
        temperature=args.temperature,
        negative_per_query=args.negative_per_query,
        quantize=False,
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
    out = stage1.train(model, batches, hp, args.output_dir, tokenizer=tokenizer,
                       valid_set=valid_set, device=dev, mesh=mesh)
    logger.info("finished at step %d (best %.5f)", out["step"], out["best_metric"])
    if mesh is not None and not mesh.is_main:
        return out
    export_dir = export_best(args.output_dir, args.model_name_or_path, dev)
    logger.info("exported HF checkpoint to %s", export_dir)
    return out


if __name__ == "__main__":
    main()
