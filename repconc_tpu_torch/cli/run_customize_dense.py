"""Stamp `similarity_metric` and `pooling` into an HF dense checkpoint on
the port (counterpart of repconc_tpu/cli/run_customize_dense.py, pipeline
stage 2; reference: utils/customize_trained_dense.py). The stamped
config.json is what later stages configure themselves from.

  python -m repconc_tpu_torch.cli.run_customize_dense \\
      --model_name_or_path <hf_dir> --similarity_metric METRIC_IP \\
      --pooling mean --output_dir <out>

Host only: no device is used.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil

from repconc_tpu_torch.core.logging_utils import setup_logging


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name_or_path", required=True)
    parser.add_argument("--similarity_metric", required=True,
                        choices=["METRIC_IP", "METRIC_COS"])
    parser.add_argument("--pooling", required=True, choices=["cls", "mean"])
    parser.add_argument("--output_dir", required=True)
    args = parser.parse_args(argv)
    setup_logging()

    os.makedirs(args.output_dir, exist_ok=True)
    src = args.model_name_or_path
    with open(os.path.join(src, "config.json")) as f:
        cfg = json.load(f)
    cfg["similarity_metric"] = args.similarity_metric
    cfg["pooling"] = args.pooling
    with open(os.path.join(args.output_dir, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    for name in os.listdir(src):
        path = os.path.join(src, name)
        if name != "config.json" and os.path.isfile(path):
            shutil.copy(path, os.path.join(args.output_dir, name))


if __name__ == "__main__":
    main()
