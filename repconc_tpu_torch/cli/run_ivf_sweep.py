"""IVF nprobe sweep on the port: recall against the exact flat ranking and
queries/s at each nprobe, for one built code index (counterpart of
repconc_tpu/cli/run_ivf_sweep.py, with its flags and its sweep.json keys).

Builds the IVF index from the codes (the coarse quantizer trains on PQ
reconstructions, or on --corpus_embed_path), then for each nprobe searches
once to warm up and once timed, and scores recall@topk against the exact
baseline: the flat ADC search of the same codes (on a GPU, K1's two
passes with the bf16 LUT, as batch_adc_search serves it; on the CPU, the
plain scorer with the fp32 LUT, as the JAX package takes on the CPU).
--use_pallas serves with CudaIVFIndex (the two IVF passes, K2 / K3, or
decoded residency with --serving decoded*); without it, the exact fp32-LUT
scan `search_xla`. Times are host clocks around a search that ends by
copying its results to the host.

Usage:
  python -m repconc_tpu_torch.cli.run_ivf_sweep \\
      --codes_path codes.npy --query_embed_path query_embeds.npy \\
      --model_name_or_path <model_dir> --nlist 4096 \\
      --nprobes 8,16,32,64,128 --topk 100 --use_pallas --out sweep.json
"""
from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np

logger = logging.getLogger(__name__)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--codes_path", required=True)
    parser.add_argument("--corpus_embed_path", default=None,
                        help="rotated corpus embeddings aligned with the "
                             "codes, from the encoder that produced them; "
                             "omit to train the coarse quantizer on PQ "
                             "reconstructions, as run_repconc_eval does")
    parser.add_argument("--query_embed_path", required=True)
    parser.add_argument("--model_name_or_path", required=True,
                        help="RepCONC model dir (for the centroids)")
    parser.add_argument("--nlist", type=int, default=4096)
    parser.add_argument("--nprobes", default="8,16,32,64,128")
    parser.add_argument("--topk", type=int, default=100)
    parser.add_argument("--balanced", action="store_true")
    parser.add_argument("--use_pallas", action="store_true",
                        help="serve with the cell-grouped path (the CUDA "
                             "passes on a GPU, their plain versions on the "
                             "CPU)")
    parser.add_argument("--lut_dtype", default="bf16",
                        choices=["bf16", "int8"],
                        help="with --use_pallas: the LUT of ADC serving")
    parser.add_argument("--serving", default="adc",
                        choices=["adc", "decoded", "decoded_int8"],
                        help="with --use_pallas: decoded-residency serving")
    parser.add_argument("--out", default="sweep.json")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (default) or cpu")
    return parser


def recall_vs_exact(ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """Mean over queries of |returned ∩ exact| / |exact|, the exact set
    without its -1 pads (run_ivf_sweep.py:101-106)."""
    return float(np.mean([
        len(set(ids[q]) & exact_q) / max(1, len(exact_q))
        for q in range(len(ids))
        for exact_q in [set(exact_ids[q]) - {-1}]]))


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        format="%(asctime)s - %(levelname)s - %(name)s - %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S", level=logging.INFO)

    import torch

    from repconc_tpu_torch.core.checkpoint import load_model
    from repconc_tpu_torch.core.device import resolve_device
    from repconc_tpu_torch.index.adc import adc_search
    from repconc_tpu_torch.index.cuda_adc import CudaADCIndex
    from repconc_tpu_torch.index.cuda_ivf import CudaIVFIndex
    from repconc_tpu_torch.index.ivf import (build_ivf, build_ivf_from_codes,
                                             search_xla)

    dev = resolve_device(args.device)
    codes = np.load(args.codes_path)
    queries = np.load(args.query_embed_path).astype(np.float32)
    _, params = load_model(args.model_name_or_path)
    centroids = np.asarray(params["centroids"], np.float32)

    logger.info("exact baseline (flat ADC) ...")
    if dev.type == "cuda":
        _, exact_ids = CudaADCIndex(codes, centroids, device=dev).search(
            queries, topk=args.topk)
    else:
        _, exact_ids = adc_search(queries, codes, centroids, topk=args.topk,
                                  device=dev)

    if args.corpus_embed_path:
        index = build_ivf(np.load(args.corpus_embed_path), codes, centroids,
                          nlist=args.nlist, balanced=args.balanced,
                          device=dev)
    else:
        index = build_ivf_from_codes(codes, centroids, nlist=args.nlist,
                                     balanced=args.balanced, device=dev)
    searcher = CudaIVFIndex(index, device=dev) if args.use_pallas else None

    results = []
    for nprobe in [int(x) for x in args.nprobes.split(",")]:
        def run():
            if searcher is not None:
                return searcher.search(queries, topk=args.topk, nprobe=nprobe,
                                       lut_dtype=args.lut_dtype,
                                       serving=args.serving)
            return search_xla(index, queries, topk=args.topk, nprobe=nprobe,
                              device=dev)

        run()  # warm: builds a decoded store, allocator pools
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        _, ids = run()  # numpy: the copy to the host ends the search
        dt = time.perf_counter() - t0
        row = {"nprobe": nprobe, "qps": round(len(queries) / dt, 2),
               "recall_vs_exact@%d" % args.topk:
                   round(recall_vs_exact(ids, exact_ids), 4)}
        logger.info("%s", row)
        results.append(row)

    with open(args.out, "w") as f:
        json.dump({"nlist": args.nlist, "topk": args.topk,
                   "serving": ((args.serving if args.serving != "adc"
                                else "pallas") if args.use_pallas else "xla"),
                   "lut_dtype": args.lut_dtype if args.use_pallas else "fp32",
                   "results": results}, f, indent=1)
    logger.info("sweep -> %s", args.out)
    return results


if __name__ == "__main__":
    main()
