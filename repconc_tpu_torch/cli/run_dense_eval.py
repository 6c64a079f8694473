"""Dense (uncompressed) retrieval eval on the port (counterpart of
repconc_tpu/cli/run_dense_eval.py, pipeline stage 3; reference:
evaluate/run_dense_eval.py): encode the corpus and the queries to fp32
embeddings, exact flat inner-product search, TREC metrics.

  python -m repconc_tpu_torch.cli.run_dense_eval \\
      --model_name_or_path <hf_dir> --corpus_path ... --query_path ... \\
      --qrel_path ... --out_corpus_dir <c> --out_query_dir <q> \\
      --save_corpus_embed [--device cuda|cpu]

The flags are the JAX CLI's, plus --device (default cuda: without a card it
raises). The artifacts are the JAX CLI's, each skip-if-exists:

  out_corpus_dir/corpus_embeds.npy, corpus_ids.npy (--save_corpus_embed),
                encode_shards/ (the resumable encode; without
                --save_corpus_embed the shards are the cache)
  out_query_dir/query_embeds.npy, qids.npy (--save_query_embed), run.tsv,
                metric.json

The corpus embeddings feed the OPQ warm-up (run_warmup).
--token_cache_dir reads a run_pretokenize cache. --data_parallel joins the
process group of the env contract (core/distributed.py; under torchrun or
REPCONC_*, one process per GPU), encodes over its ranks and searches the
corpus sharded over them (ShardedFlatIndex); rank 0 alone writes the
artifacts (run_dense_eval.py:95-100,155-158).
"""
from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from repconc_tpu_torch.core.checkpoint import atomic_np_save
from repconc_tpu_torch.core.config import (METRIC_CENTROID_COS, METRIC_IP,
                                           RepConcConfig)
from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.core.mesh import create_mesh
from repconc_tpu_torch.core.logging_utils import setup_logging
from repconc_tpu_torch.eval.encode import (clear_encode_cache, encode_corpus,
                                           encode_queries)
from repconc_tpu_torch.eval.run_io import (
    load_beir_corpus, load_beir_qrels, load_beir_queries, load_corpus,
    load_queries, write_run_tsv,
)
from repconc_tpu_torch.eval.trec import evaluate_run
from repconc_tpu_torch.index.flat import batch_flat_search
from repconc_tpu_torch.parallel.sharded import sharded_batch_flat_search

logger = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name_or_path", required=True)
    parser.add_argument("--corpus_path", required=True)
    parser.add_argument("--query_path", required=True)
    parser.add_argument("--qrel_path", default=None)
    parser.add_argument("--out_corpus_dir", required=True)
    parser.add_argument("--out_query_dir", required=True)
    parser.add_argument("--data_format", default="msmarco",
                        choices=["msmarco", "beir"])
    parser.add_argument("--max_seq_length", type=int, default=512)
    parser.add_argument("--similarity_metric", default=None)
    parser.add_argument("--pooling", default=None)
    parser.add_argument("--per_device_eval_batch_size", type=int, default=256)
    parser.add_argument("--token_cache_dir", default=None,
                        help="pretokenized corpus (run_pretokenize); a "
                             "missing or stale cache tokenizes online")
    parser.add_argument("--relevance_level", type=int, default=1,
                        help="minimum qrel grade counted relevant for the "
                             "binary metrics")
    parser.add_argument("--topk", type=int, default=100)
    parser.add_argument("--search_batch", type=int, default=1200)
    parser.add_argument("--adapter", default=None,
                        help="custom model adapter (e.g. ance, tct)")
    parser.add_argument("--save_corpus_embed", action="store_true")
    parser.add_argument("--save_query_embed", action="store_true")
    parser.add_argument("--data_parallel", action="store_true",
                        help="encode and search over the ranks of the "
                             "process group (one process per GPU)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    return parser


def load_model(model_dir: str, adapter=None, pooling=None,
               similarity_metric=None, device="cuda"):
    """The HF encoder wrapped in a RepConcModel with an identity rotation
    (run_dense_eval.py:63-88): M=1 and K=2 are placeholders, no
    quantization runs, and METRIC_CENTROID_COS ranks by inner product, so
    the embeddings are the encoder's pooled output."""
    from repconc_tpu_torch.models.auto import load_dense_encoder
    from repconc_tpu_torch.models.repconc_model import RepConcModel

    enc_cfg, enc_state, metric = load_dense_encoder(model_dir, adapter=adapter,
                                                    device="cpu")
    if pooling:
        enc_cfg.pooling = pooling
    metric = similarity_metric or metric
    config = RepConcConfig(encoder=enc_cfg, MCQ_M=1, MCQ_K=2,
                           similarity_metric=(METRIC_IP if metric ==
                                              METRIC_CENTROID_COS else metric))
    model = RepConcModel(config)
    model.encoder.load_state_dict(enc_state, strict=True)
    return model.eval().to(resolve_device(device))


def main(argv=None):
    args = build_parser().parse_args(argv)
    setup_logging()
    from repconc_tpu_torch.models.adapters import load_adapter_tokenizer

    mesh = create_mesh(args.device) if args.data_parallel else None
    device = resolve_device(args.device) if mesh is None else mesh.device
    main_rank = mesh is None or mesh.is_main
    tokenizer = load_adapter_tokenizer(args.model_name_or_path, args.adapter)
    model = load_model(args.model_name_or_path, args.adapter, args.pooling,
                       args.similarity_metric, device)
    if args.data_format == "msmarco":
        corpus_loader = lambda p: load_corpus(p, tokenizer.sep_token)
        query_loader = load_queries
    else:
        corpus_loader, query_loader = load_beir_corpus, load_beir_queries

    emb_path = os.path.join(args.out_corpus_dir, "corpus_embeds.npy")
    ids_path = os.path.join(args.out_corpus_dir, "corpus_ids.npy")
    if os.path.exists(emb_path) and os.path.exists(ids_path):
        logger.info("Load pre-computed corpus representations")
        corpus_embeds, corpus_ids = np.load(emb_path), np.load(ids_path)
    else:
        shard_cache = os.path.join(args.out_corpus_dir, "encode_shards")
        corpus_embeds, corpus_ids = encode_corpus(
            corpus_loader(args.corpus_path), model, tokenizer,
            args.max_seq_length, batch_size=args.per_device_eval_batch_size,
            output="continuous_embedding", device=device,
            cache_dir=shard_cache, token_cache_dir=args.token_cache_dir,
            mesh=mesh)
        if args.save_corpus_embed and main_rank:
            atomic_np_save(emb_path, corpus_embeds)
            atomic_np_save(ids_path, corpus_ids)
            clear_encode_cache(shard_cache)
        # without --save_corpus_embed the shards are the cache: a rerun
        # resumes from them

    qemb_path = os.path.join(args.out_query_dir, "query_embeds.npy")
    qids_path = os.path.join(args.out_query_dir, "qids.npy")
    if os.path.exists(qemb_path) and os.path.exists(qids_path):
        logger.info("Load pre-computed query representations")
        query_embeds, query_ids = np.load(qemb_path), np.load(qids_path)
    else:
        query_embeds, query_ids = encode_queries(
            query_loader(args.query_path), model, tokenizer,
            args.max_seq_length, batch_size=args.per_device_eval_batch_size,
            device=device, mesh=mesh)
        if args.save_query_embed and main_rank:
            os.makedirs(args.out_query_dir, exist_ok=True)
            atomic_np_save(qemb_path, query_embeds)
            atomic_np_save(qids_path, query_ids)

    out_metric_path = os.path.join(args.out_query_dir, "metric.json")
    if os.path.exists(out_metric_path):
        logger.info("Skip search: metric.json already exists")
        return
    if mesh is None:
        scores, topk_ids = batch_flat_search(
            query_ids, query_embeds, corpus_ids, corpus_embeds, topk=args.topk,
            batch_size=args.search_batch, device=device)
    else:
        scores, topk_ids = sharded_batch_flat_search(
            mesh, query_ids, query_embeds, corpus_ids, corpus_embeds,
            topk=args.topk, batch_size=args.search_batch)
    if not main_rank:
        return
    os.makedirs(args.out_query_dir, exist_ok=True)
    out_run_path = os.path.join(args.out_query_dir, "run.tsv")
    write_run_tsv(out_run_path, query_ids, scores, topk_ids)

    if args.qrel_path is None:
        return
    qrels = (args.qrel_path if args.data_format == "msmarco"
             else load_beir_qrels(args.qrel_path))
    metrics = evaluate_run(qrels, out_run_path,
                           relevance_level=args.relevance_level)
    for k, v in metrics.items():
        if k != "perquery":
            logger.info("%s", v)
    with open(out_metric_path, "w") as f:
        json.dump(metrics, f, indent=1)


if __name__ == "__main__":
    main()
