"""The held-out check on real M=12 models: the inputs of a leg's flat
search, kept as a fixture, and the comparisons of its runs. One fixture a
leg:

  heldout_m12/      RepCONC: the M=12 RepCONC checkpoint
                    (artifacts/r5h_m12_conc_best.tar, best/), as
                    recipes/run_pipeline.sh stage 8 runs it
  heldout_m12_opq/  OPQ: the warm-up model that stage 5 fits on the dense
                    export (artifacts/r5h_export_hf.tar), as the recipe's
                    opq-eval runs it (repconc_tpu_torch/recipes/
                    heldout_matrix.sh, LEGS="dense opq")
  heldout_dense/    dense: stages 2-3 on the same export; its 614 MB of
                    corpus embeddings fit no checkout, so it holds only
                    the CPU run's metric.json (dense/dev/metric.json)

Each is cut from one CPU run of the port's run_repconc_eval over the
held-out task split of the seeded synthetic corpus (make_pipeline_data.py
synth --n_docs 200000, complete-qrels --splits train,dev.small,
split-heldout; data_task), at --max_seq_length 128 --topk 1000:

  search_inputs.npz  codes (200000, 12) uint8 and corpus_ids, in encode
                     order; qids and query_embeds (241, 768) fp32, in qid
                     order; centroids (12, 256, 64) fp32, the model's
  qrels.dev.tsv      data_task's dev qrels
  metric.json        that run's metric.json, perquery included

The JAX package's run of the same model (bf16 LUT on the TPU) is
docs/heldout_r5/m12_conc_index_dev.json.

  python -m repconc_tpu_torch.fixtures.heldout build \\
      --corpus_dir <out_corpus_dir> --query_dir <out_query_dir> \\
      --model_dir <best/> --qrel_path <data_task>/qrels.dev.small.tsv
  python -m repconc_tpu_torch.fixtures.heldout compare \\
      --metric <metric.json> --reference docs/heldout_r5/m12_conc_index_dev.json \\
      [--leg heldout_m12_opq]

`build --out_dir` writes another leg's fixture. `compare` prints one JSON
object: both runs' MRR@10 and NDCG@10, their differences, the queries
whose metrics differ and whether the leg's bars are met. Nothing here
needs a card.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Any, Dict

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# each leg's fixture: the TPU run it is held to (docs/heldout_r5/), that
# run's MRR@10, and the bars on |port - TPU|, each set before the port's run
LEGS = {
    "heldout_m12": dict(reference="m12_conc_index_dev.json",
                        tpu_mrr10=0.63838, mrr10_bar=0.02, ndcg10_bar=None),
    "heldout_m12_opq": dict(reference="m12_opq_index_dev.json",
                            tpu_mrr10=0.49315, mrr10_bar=0.03,
                            ndcg10_bar=0.03),
    "heldout_dense": dict(reference="dense_dev.json", tpu_mrr10=0.51141,
                          mrr10_bar=0.02, ndcg10_bar=0.02),
}
FIXTURE_DIR = os.path.join(HERE, "heldout_m12")
OPQ_FIXTURE_DIR = os.path.join(HERE, "heldout_m12_opq")
DENSE_FIXTURE_DIR = os.path.join(HERE, "heldout_dense")
INPUTS = "search_inputs.npz"
QRELS = "qrels.dev.tsv"
METRIC = "metric.json"
TOPK = 1000
SEARCH_BATCH = 1200  # run_repconc_eval's --search_batch default
TPU_MRR10 = LEGS["heldout_m12"]["tpu_mrr10"]
MRR10_BAR = LEGS["heldout_m12"]["mrr10_bar"]


def load(fixture_dir: str = FIXTURE_DIR) -> Dict[str, Any]:
    """The fixture's arrays, the path of its qrels and its metric.json."""
    with np.load(os.path.join(fixture_dir, INPUTS)) as z:
        out = {k: z[k] for k in z.files}
    out["qrel_path"] = os.path.join(fixture_dir, QRELS)
    with open(os.path.join(fixture_dir, METRIC)) as f:
        out["metric"] = json.load(f)
    return out


def search(fx: Dict[str, Any], device="cuda", searcher=None):
    """The eval CLI's flat search over the fixture: (scores, docids), each
    (241, 1000), through index/adc.py::batch_adc_search (K1's two passes on
    a card, the fp32 LUT's plain scan on the CPU). `searcher`: a
    CudaADCIndex already holding the fixture's codes."""
    from repconc_tpu_torch.index.adc import batch_adc_search

    return batch_adc_search(fx["qids"], fx["query_embeds"], fx["corpus_ids"],
                            fx["codes"], fx["centroids"], topk=TOPK,
                            batch_size=SEARCH_BATCH, device=device,
                            searcher=searcher)


def score_run(fx: Dict[str, Any], scores, docids, run_path: str) -> dict:
    """Write the TREC run and score it as the eval CLI does."""
    from repconc_tpu_torch.eval.run_io import write_run_tsv
    from repconc_tpu_torch.eval.trec import evaluate_run

    write_run_tsv(run_path, fx["qids"], scores, docids)
    return evaluate_run(fx["qrel_path"], run_path)


def compare(metric: dict, reference: dict) -> dict:
    """MRR@10 and NDCG@10 of both runs, and per query the recip_rank_10
    and ndcg_cut_10 of each run where any per-query metric differs."""
    got, want = metric["perquery"], reference["perquery"]
    if set(got) != set(want):
        raise ValueError(f"the runs judge other queries ({len(got)} vs "
                         f"{len(want)})")
    differ = {q: {k: [want[q][k], got[q][k]]
                  for k in ("recip_rank_10", "ndcg_cut_10")}
              for q in sorted(got) if got[q] != want[q]}
    mrr, ref_mrr = metric["mrr"]["MRR@10"], reference["mrr"]["MRR@10"]
    ndcg, ref_ndcg = metric["ndcg"]["NDCG@10"], reference["ndcg"]["NDCG@10"]
    return {"mrr_at_10": mrr, "reference_mrr_at_10": ref_mrr,
            "delta_mrr_at_10": mrr - ref_mrr,
            "ndcg_at_10": ndcg, "reference_ndcg_at_10": ref_ndcg,
            "delta_ndcg_at_10": ndcg - ref_ndcg,
            "queries": len(got), "queries_differ": len(differ),
            "mrr10_differ": sum(v["recip_rank_10"][0] != v["recip_rank_10"][1]
                                for v in differ.values()),
            "perquery_differ": differ}


def bars_met(out: dict, leg: str) -> bool:
    """Whether compare()'s output against the TPU run meets the leg's
    bars."""
    bars = LEGS[leg]
    return (abs(out["delta_mrr_at_10"]) <= bars["mrr10_bar"]
            and (bars["ndcg10_bar"] is None
                 or abs(out["delta_ndcg_at_10"]) <= bars["ndcg10_bar"]))


def build(corpus_dir: str, query_dir: str, model_dir: str, qrel_path: str,
          out_dir: str = FIXTURE_DIR) -> None:
    """Cut the fixture from an eval run's caches (codes.npy, corpus_ids.npy;
    codes.npy, qids.npy, metric.json) and the model's centroids."""
    from repconc_tpu_torch.core.checkpoint import load_params

    centroids = np.asarray(load_params(model_dir)["centroids"], np.float32)
    os.makedirs(out_dir, exist_ok=True)
    np.savez_compressed(
        os.path.join(out_dir, INPUTS),
        codes=np.load(os.path.join(corpus_dir, "codes.npy")),
        corpus_ids=np.load(os.path.join(corpus_dir, "corpus_ids.npy")),
        qids=np.load(os.path.join(query_dir, "qids.npy")),
        query_embeds=np.load(os.path.join(query_dir, "codes.npy")),
        centroids=centroids)
    shutil.copy(qrel_path, os.path.join(out_dir, QRELS))
    shutil.copy(os.path.join(query_dir, "metric.json"),
                os.path.join(out_dir, METRIC))


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build")
    b.add_argument("--corpus_dir", required=True)
    b.add_argument("--query_dir", required=True)
    b.add_argument("--model_dir", required=True)
    b.add_argument("--qrel_path", required=True)
    b.add_argument("--out_dir", default=FIXTURE_DIR)
    c = sub.add_parser("compare")
    c.add_argument("--metric", default=os.path.join(FIXTURE_DIR, METRIC))
    c.add_argument("--reference", required=True)
    c.add_argument("--leg", default="heldout_m12", choices=sorted(LEGS))
    args = p.parse_args(argv)
    if args.cmd == "build":
        build(args.corpus_dir, args.query_dir, args.model_dir, args.qrel_path,
              args.out_dir)
        return
    with open(args.metric) as f, open(args.reference) as g:
        out = compare(json.load(f), json.load(g))
    out["bars"] = {k: LEGS[args.leg][k] for k in ("mrr10_bar", "ndcg10_bar")}
    out["bar_met"] = bars_met(out, args.leg)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
