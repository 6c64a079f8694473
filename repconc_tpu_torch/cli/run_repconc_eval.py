"""RepCONC index build + retrieval eval on the port (counterpart of
repconc_tpu/cli/run_repconc_eval.py:32-277, flat and IVF indexes).

Encodes the corpus to uint8 codes with the DOC encoder and the queries to
fp32 embeddings with the QUERY encoder, then ADC-searches with the QUERY
encoder's centroids (the stage-2 centroid swap, :182-183). The cache layout
is the JAX package's, so either package searches caches the other wrote:

  out_corpus_dir/codes.npy, corpus_ids.npy, ivf_index.npz (--index_type ivf),
                encode_shards/ (the resumable encode, removed once codes.npy
                is saved)
  out_query_dir/codes.npy (fp32 query embeddings), qids.npy, run.tsv,
                metric.json, timings.json

Every artifact is skip-if-exists. Options of the JAX CLI that the port does
not have yet raise NotImplementedError naming their ROADMAP.md item.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import zipfile

import numpy as np

from repconc_tpu_torch.core.checkpoint import atomic_np_save
from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.core.profiling import Stopwatch
from repconc_tpu_torch.eval.encode import (clear_encode_cache, encode_corpus,
                                           encode_queries)
from repconc_tpu_torch.eval.run_io import (
    load_beir_corpus, load_beir_qrels, load_beir_queries, load_corpus,
    load_queries, write_run_tsv,
)
from repconc_tpu_torch.eval.trec import evaluate_run
from repconc_tpu_torch.index.adc import batch_adc_search
from repconc_tpu_torch.index.ivf import (IVFIndex, build_ivf_from_codes,
                                         serve_search)

logger = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name_or_path", default=None)
    parser.add_argument("--doc_encoder_path", default=None)
    parser.add_argument("--query_encoder_path", default=None)
    parser.add_argument("--max_seq_length", type=int, default=512)
    parser.add_argument("--corpus_path", required=True)
    parser.add_argument("--query_path", required=True)
    parser.add_argument("--qrel_path", default=None)
    parser.add_argument("--out_corpus_dir", required=True)
    parser.add_argument("--out_query_dir", required=True)
    parser.add_argument("--data_format", default="msmarco",
                        choices=["msmarco", "beir"])
    parser.add_argument("--per_device_eval_batch_size", type=int, default=256)
    parser.add_argument("--token_cache_dir", default=None,
                        help="pretokenized corpus (run_pretokenize); a "
                             "missing or stale cache tokenizes online")
    parser.add_argument("--relevance_level", type=int, default=1,
                        help="minimum qrel grade counted relevant for the "
                             "binary metrics")
    parser.add_argument("--topk", type=int, default=1000)
    parser.add_argument("--search_batch", type=int, default=1200)
    parser.add_argument("--adapter", default=None,
                        help="custom model adapter (e.g. ance, tct)")
    parser.add_argument("--index_type", default="flat", choices=["flat", "ivf"])
    parser.add_argument("--nlist", type=int, default=4096)
    parser.add_argument("--nprobe", type=int, default=64)
    parser.add_argument("--serving", default="auto",
                        choices=["auto", "pallas", "xla", "decoded", "decoded_int8"],
                        help="IVF serving path: auto (the CUDA kernels on a "
                             "GPU, the exact scan on the CPU), pallas (the "
                             "cell-grouped path forced), xla (the exact "
                             "fp32-LUT scan), decoded / decoded_int8 (bf16 / "
                             "int8 reconstructions resident, the cell-grouped "
                             "path on any device)")
    parser.add_argument("--lut_dtype", default="bf16", choices=["bf16", "int8"])
    parser.add_argument("--data_parallel", action="store_true")
    parser.add_argument("--corpus_embed_path", default=None,
                        help="DEPRECATED, ignored (as in the JAX CLI)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    return parser


def check_ported(args) -> None:
    """Options whose paths the port does not have yet raise; nothing falls
    back to another path."""
    pending = [
        (args.data_parallel, "--data_parallel", "Queue 1 item 10 (multi-GPU)"),
    ]
    for hit, flag, item in pending:
        if hit:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md, {item})")


def resolve_paths(args):
    if args.model_name_or_path is not None:
        if args.doc_encoder_path is not None or args.query_encoder_path is not None:
            raise SystemExit("--model_name_or_path excludes --doc_encoder_path "
                             "and --query_encoder_path")
        return args.model_name_or_path, args.model_name_or_path
    return args.doc_encoder_path, args.query_encoder_path


def load_model_and_tokenizer(model_dir: str, adapter, device):
    from repconc_tpu_torch.models.adapters import load_adapter_tokenizer
    from repconc_tpu_torch.models.repconc_model import from_pretrained

    model = from_pretrained(model_dir, device=device)
    tokenizer = load_adapter_tokenizer(model_dir, adapter or
                                       model.config.encoder.model_type)
    return model, tokenizer


def search_ivf(codes, corpus_ids, query_embeds, centroids, out_corpus_dir,
               args, device, stopwatch):
    """The --index_type ivf branch (repconc_tpu/cli/run_repconc_eval.py:
    184-240): load out_corpus_dir/ivf_index.npz, or build it from the codes
    when it is missing, unreadable or stale (another nlist, another corpus
    size), save it, swap in the QUERY model's centroids and serve.

    args needs nlist, nprobe, topk, search_batch, serving and lut_dtype.
    Returns (scores, docids); a -1 pad row maps to corpus_ids[0] with a
    -inf score, which write_run_tsv drops.
    """
    ivf_path = os.path.join(out_corpus_dir, "ivf_index.npz")
    nlist = min(args.nlist, codes.shape[0])
    with stopwatch("build_ivf"):
        ivf = None
        if os.path.exists(ivf_path):
            try:
                ivf = IVFIndex.load(out_corpus_dir)
            except (OSError, ValueError, TypeError, KeyError, EOFError,
                    zipfile.BadZipFile) as e:  # a partial npz from a killed run
                logger.warning("cached ivf_index.npz unreadable (%s): "
                               "rebuilding", e)
            if ivf is not None and (ivf.nlist != nlist
                                    or ivf.ntotal != codes.shape[0]):
                logger.warning("cached ivf_index.npz is stale (nlist %d vs %d, "
                               "ntotal %d vs %d docs): rebuilding", ivf.nlist,
                               nlist, ivf.ntotal, codes.shape[0])
                ivf = None
        if ivf is None:
            # the coarse quantizer trains on PQ reconstructions of the codes
            # being served (run_repconc_eval.py:211-228)
            ivf = build_ivf_from_codes(codes, centroids, nlist=args.nlist,
                                       device=device, stopwatch=stopwatch)
            ivf.save(out_corpus_dir)
    ivf.set_centroids(centroids)
    decoded = args.serving in ("decoded", "decoded_int8")
    with stopwatch("search"):
        scores, row_ids = serve_search(
            ivf, query_embeds, topk=args.topk, nprobe=args.nprobe,
            search_batch=args.search_batch,
            mode="pallas" if decoded else args.serving,
            lut_dtype=args.lut_dtype,
            serving=args.serving if decoded else "adc", device=device)
    return scores, corpus_ids[np.maximum(row_ids, 0)]


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)
    check_ported(args)
    device = resolve_device(args.device)
    doc_dir, query_dir = resolve_paths(args)
    sw = Stopwatch()

    # --- corpus codes (cached) ---
    if (os.path.abspath(args.out_corpus_dir)
            == os.path.abspath(args.out_query_dir)):
        # both caches are named codes.npy (reference layout): one dir would
        # overwrite corpus codes with query embeddings
        raise SystemExit("--out_corpus_dir and --out_query_dir must differ")
    codes_path = os.path.join(args.out_corpus_dir, "codes.npy")
    cids_path = os.path.join(args.out_corpus_dir, "corpus_ids.npy")
    if os.path.exists(codes_path) and os.path.exists(cids_path):
        logger.info("Load pre-computed corpus codes")
        codes, corpus_ids = np.load(codes_path), np.load(cids_path)
    else:
        model, tokenizer = load_model_and_tokenizer(doc_dir, args.adapter, device)
        with sw("load_corpus"):
            if args.data_format == "msmarco":
                corpus = load_corpus(args.corpus_path, tokenizer.sep_token)
            else:
                corpus = load_beir_corpus(args.corpus_path)
        shard_cache = os.path.join(args.out_corpus_dir, "encode_shards")
        with sw("encode_corpus"):
            codes, corpus_ids = encode_corpus(
                corpus, model, tokenizer, args.max_seq_length,
                batch_size=args.per_device_eval_batch_size, output="code",
                device=device, stopwatch=sw, cache_dir=shard_cache,
                token_cache_dir=args.token_cache_dir)
        del model
        atomic_np_save(codes_path, codes)
        atomic_np_save(cids_path, corpus_ids)
        clear_encode_cache(shard_cache)

    # --- query embeddings (cached) ---
    qemb_path = os.path.join(args.out_query_dir, "codes.npy")  # reference name
    qids_path = os.path.join(args.out_query_dir, "qids.npy")
    q_model, q_tokenizer = load_model_and_tokenizer(query_dir, args.adapter,
                                                    device)
    if os.path.exists(qemb_path) and os.path.exists(qids_path):
        logger.info("Load pre-computed query representations")
        query_embeds, query_ids = np.load(qemb_path), np.load(qids_path)
    else:
        if args.data_format == "msmarco":
            queries = load_queries(args.query_path)
        else:
            queries = load_beir_queries(args.query_path)
        with sw("encode_queries"):
            query_embeds, query_ids = encode_queries(
                queries, q_model, q_tokenizer, args.max_seq_length,
                batch_size=args.per_device_eval_batch_size, device=device)
        os.makedirs(args.out_query_dir, exist_ok=True)
        atomic_np_save(qemb_path, query_embeds)
        atomic_np_save(qids_path, query_ids)

    out_metric_path = os.path.join(args.out_query_dir, "metric.json")
    if os.path.exists(out_metric_path):
        logger.info("Skip search: metric.json already exists")
        return

    # --- search with the QUERY model's centroids (stage-2 swap semantics) ---
    centroids = q_model.centroids.detach().cpu().numpy()
    if args.index_type == "ivf":
        scores, topk_ids = search_ivf(codes, corpus_ids, query_embeds,
                                      centroids, args.out_corpus_dir, args,
                                      device, sw)
    else:
        with sw("search"):
            scores, topk_ids = batch_adc_search(
                query_ids, query_embeds, corpus_ids, codes, centroids,
                topk=args.topk, batch_size=args.search_batch, device=device)
    out_run_path = os.path.join(args.out_query_dir, "run.tsv")
    write_run_tsv(out_run_path, query_ids, scores, topk_ids)
    logger.info("phase wall-clock (s): %s",
                {k: round(v, 2) for k, v in sw.totals.items()})
    with open(os.path.join(args.out_query_dir, "timings.json"), "w") as f:
        json.dump({k: round(v, 3) for k, v in sw.totals.items()}, f, indent=1)

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
