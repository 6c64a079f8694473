"""Mine hard negatives for stage-1 training from a warm-up retrieval run
on the port (counterpart of repconc_tpu/cli/run_extract_hardneg.py,
pipeline stage 6; reference: train/run_extract_hardneg.py:7-30).

  python -m repconc_tpu_torch.cli.run_extract_hardneg --run_path run.tsv \\
      --qrel_path qrels.tsv --topk 200 --output_path hardneg.json

For each query, the run's docs at rank <= --topk that are not judged
relevant form that query's negative pool, written as {qid: [docid, ...]}
JSON in rank order: the bytes the JAX CLI writes, and what
`train.data.QDRelDataset` reads through `run_train_conc --negative`.
Host-only: no device is used.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

from repconc_tpu_torch.core.logging_utils import setup_logging
from repconc_tpu_torch.eval.run_io import iter_run, load_qrels

logger = logging.getLogger(__name__)


def mine_hard_negatives(run_path: str, positives: dict, depth: int) -> dict:
    """Top-`depth` run docids per query, minus that query's judged positives."""
    pools: dict = {}
    for qid, docid, rank in iter_run(run_path):
        if rank <= depth and docid not in positives.get(qid, ()):
            pools.setdefault(qid, []).append(docid)
    return pools


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--run_path", required=True)
    parser.add_argument("--qrel_path", required=True)
    parser.add_argument("--topk", type=int, required=True)
    parser.add_argument("--output_path", required=True)
    args = parser.parse_args(argv)
    setup_logging()

    positives = {q: set(ds) for q, ds in load_qrels(args.qrel_path).items()}
    pools = mine_hard_negatives(args.run_path, positives, args.topk)
    logger.info("mined negative pools for %d queries (depth %d)",
                len(pools), args.topk)

    os.makedirs(os.path.dirname(os.path.abspath(args.output_path)),
                exist_ok=True)
    with open(args.output_path, "w") as fh:
        json.dump(pools, fh)


if __name__ == "__main__":
    main()
