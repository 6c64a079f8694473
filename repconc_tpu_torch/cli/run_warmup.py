"""OPQ warm-up on the port (counterpart of repconc_tpu/cli/run_warmup.py,
pipeline stage 5; reference: train/run_warmup.py): fit the rotation and
centroids on the dense corpus embeddings and write the warm-up RepCONC
model dir and its code index.

  python -m repconc_tpu_torch.cli.run_warmup \\
      --model_name_or_path <customized_dense_dir> --MCQ_M 48 \\
      --input_corpus_embed_path .../corpus_embeds.npy \\
      --input_corpus_ids_path .../corpus_ids.npy \\
      --output_model_dir <out_model> --output_index_dir <out_index> \\
      [--device cuda|cpu]

The flags are the JAX CLI's, plus --device (default cuda: without a card it
raises). It writes a model dir both packages load (repconc_config.json,
params.msgpack, the tokenizer files) and output_index_dir/codes.npy,
corpus_ids.npy and centroids.npy.
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
                        help="customized dense encoder dir (HF format)")
    parser.add_argument("--MCQ_M", type=int, required=True)
    parser.add_argument("--MCQ_K", type=int, default=256)
    parser.add_argument("--similarity_metric", default=None,
                        choices=[None, "METRIC_CENTROID_COS", "METRIC_IP",
                                 "METRIC_COS"])
    parser.add_argument("--pooling", default=None, choices=[None, "cls", "mean"])
    parser.add_argument("--input_corpus_embed_path", required=True)
    parser.add_argument("--input_corpus_ids_path", required=True)
    parser.add_argument("--output_model_dir", required=True)
    parser.add_argument("--output_index_dir", required=True)
    parser.add_argument("--opq_outer_iters", type=int, default=20)
    parser.add_argument("--opq_pq_iters", type=int, default=4)
    parser.add_argument("--final_pq_iters", type=int, default=25)
    parser.add_argument("--max_train_points", type=int, default=1 << 18)
    parser.add_argument("--adapter", default=None)
    parser.add_argument("--seed", type=int, default=2022)
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging()
    from repconc_tpu_torch.core.device import resolve_device
    from repconc_tpu_torch.models import repconc_model
    from repconc_tpu_torch.train.warmup import warmup_from_embeds

    dev = resolve_device(args.device)
    model = repconc_model.from_dense_encoder(
        args.model_name_or_path, MCQ_M=args.MCQ_M, MCQ_K=args.MCQ_K,
        similarity_metric=args.similarity_metric, pooling=args.pooling,
        seed=args.seed, adapter=args.adapter, device=dev)
    # both inputs up front: a bad ids path found after the OPQ fit would
    # leave an index dir with codes and no corpus ids
    corpus_embeds = np.load(args.input_corpus_embed_path)
    corpus_ids = np.load(args.input_corpus_ids_path)
    model, codes = warmup_from_embeds(
        corpus_embeds, model, max_train_points=args.max_train_points,
        outer_iters=args.opq_outer_iters, pq_iters=args.opq_pq_iters,
        final_pq_iters=args.final_pq_iters, seed=args.seed, device=dev)
    repconc_model.save_pretrained(args.output_model_dir, model,
                                  tokenizer_dir=args.model_name_or_path)
    os.makedirs(args.output_index_dir, exist_ok=True)
    np.save(os.path.join(args.output_index_dir, "codes.npy"), codes)
    np.save(os.path.join(args.output_index_dir, "corpus_ids.npy"), corpus_ids)
    np.save(os.path.join(args.output_index_dir, "centroids.npy"),
            model.centroids.detach().cpu().numpy())
    logger.info("warmup model -> %s, index -> %s", args.output_model_dir,
                args.output_index_dir)


if __name__ == "__main__":
    main()
