"""Carve a small validation split out of the full collection on the port
(counterpart of repconc_tpu/cli/run_gen_valid_set.py, pipeline stage 4;
reference: train/run_gen_valid_set.py). The validation corpus is the
union of every judged doc of the dev qrels (any grade) and the top
`--topk` docs a dense run retrieved for each judged query: small enough to
re-encode at every validation, and holding each query's positives and its
hardest distractors. Queries and qrels pass through unchanged.

Bootstrap mode (stage 0, before any run exists): omit --input_run_path and
pass --random_sample N to pad the judged docids with N random corpus docs.

The output files are the JAX CLI's, byte for byte. Host only: no device is
used.
"""
from __future__ import annotations

import argparse
import logging
import os
import random
import shutil

from repconc_tpu_torch.core.logging_utils import setup_logging
from repconc_tpu_torch.eval.run_io import iter_run

logger = logging.getLogger(__name__)


def _judged(qrel_path: str):
    """(judged qids, judged docids) of a TREC qrels file."""
    queries, docs = set(), set()
    with open(qrel_path) as fh:
        for line in fh:
            qid, _, docid, _rel = line.split()
            queries.add(qid)
            docs.add(docid)
    return queries, docs


def select_validation_docids(qrel_path: str, run_path: str, depth: int) -> set:
    """Judged docids (all grades) + top-`depth` run docids of judged queries."""
    judged_queries, keep = _judged(qrel_path)
    for qid, docid, rank in iter_run(run_path):
        if rank <= depth and qid in judged_queries:
            keep.add(docid)
    return keep


def sample_corpus_docids(qrel_path: str, corpus_path: str, n_sample: int,
                         seed: int = 0) -> set:
    """Judged docids + `n_sample` random corpus docids (run-free bootstrap),
    drawn by random.Random(seed) as the JAX CLI draws them."""
    _, keep = _judged(qrel_path)
    with open(corpus_path) as fh:
        all_ids = [line.split("\t", 1)[0] for line in fh]
    # draw from the unjudged pool: judged and duplicate ids must not absorb
    # draws and shrink the corpus below judged + n_sample
    pool = sorted(set(all_ids) - keep)
    keep.update(random.Random(seed).sample(pool, min(n_sample, len(pool))))
    return keep


def filter_corpus_tsv(src_path: str, dst_path: str, keep: set) -> int:
    """Copy the corpus TSV lines whose id column is in `keep`; return count."""
    kept = 0
    with open(src_path) as fin, open(dst_path, "w") as fout:
        for line in fin:
            if line.split("\t", 1)[0] in keep:
                fout.write(line)
                kept += 1
    return kept


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--input_corpus_path", required=True)
    parser.add_argument("--input_query_path", required=True)
    parser.add_argument("--input_qrel_path", required=True)
    parser.add_argument("--input_run_path", default=None,
                        help="dense run to mine distractors from; omit with "
                             "--random_sample for the stage-0 bootstrap mode")
    parser.add_argument("--topk", type=int, default=100)
    parser.add_argument("--random_sample", type=int, default=0,
                        help="run-free mode: pad judged docids with N random docs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output_corpus_path", required=True)
    parser.add_argument("--output_query_path", required=True)
    parser.add_argument("--output_qrel_path", required=True)
    args = parser.parse_args(argv)
    setup_logging()

    if not args.input_run_path and args.random_sample <= 0:
        # refuse before writing: a partial output could pass for a finished
        # stage on a resumed recipe
        parser.error("need --input_run_path or --random_sample > 0")
    for path in (args.output_corpus_path, args.output_query_path,
                 args.output_qrel_path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    shutil.copy(args.input_query_path, args.output_query_path)
    shutil.copy(args.input_qrel_path, args.output_qrel_path)
    if args.input_run_path:
        keep = select_validation_docids(args.input_qrel_path,
                                        args.input_run_path, args.topk)
    else:
        keep = sample_corpus_docids(args.input_qrel_path,
                                    args.input_corpus_path,
                                    args.random_sample, seed=args.seed)
    kept = filter_corpus_tsv(args.input_corpus_path, args.output_corpus_path,
                             keep)
    logger.info("validation corpus: wrote %d of %d selected docids to %s",
                kept, len(keep), args.output_corpus_path)


if __name__ == "__main__":
    main()
