#!/bin/bash
# Bert-base-scale offline rehearsal on the PyTorch / CUDA port: the twin of
# recipes/synthetic/run_synth.sh, step for step and value for value. A
# 200k-doc synthetic corpus, a real 12-layer encoder, the IVF eval path, all
# three recipe variants (RepCONC / OPQ-only / JPQ-only). Per-stage
# wall-clock is recorded to ${WS}/stage_times.tsv.
#
# By default every variant starts from a CONVERGED dense encoder, produced
# by pipeline stage 0 (dense contrastive pre-training of the random-init
# bert-base on the synthetic task), as the reference's experimental setup
# does (examples/sentence-bert/README.md:11-17). Set PRETRAIN=0 to skip
# stage 0 and run from random init.
#
#   DEVICE=cuda bash repconc_tpu_torch/recipes/run_synth.sh [workspace] [n_docs]
#
# Where it departs from recipes/synthetic/run_synth.sh:
#   1. The data step is make_pipeline_data.py synth (the JAX maker's files,
#      byte for byte, without transformers), and every stage runs through
#      the port's run_pipeline.sh beside this script.
#   2. DEVICE (default cuda) is exported, so it reaches every CLI that takes
#      a device.
set -eu
WS=${1:-./synth_workspace}
NDOCS=${2:-200000}
PRETRAIN=${PRETRAIN:-1}
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(cd "${HERE}/../.." && pwd)
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"
export DEVICE=${DEVICE:-cuda}

if [ ! -f "${WS}/data/corpus.tsv" ]; then
  python -m repconc_tpu_torch.recipes.make_pipeline_data synth \
    --out_dir "${WS}" --n_docs "${NDOCS}"
fi

TIMES="${WS}/stage_times.tsv"
: > "${TIMES}"
run_stage() {  # run_stage <env> <stage>
  T0=$(date +%s)
  bash "${HERE}/run_pipeline.sh" "$1" "$2"
  echo -e "$2\t$(( $(date +%s) - T0 ))s" | tee -a "${TIMES}"
}

HF_DIR="${WS}/models/synth-bert-base"
if [ "${PRETRAIN}" = "1" ]; then
  cat > "${WS}/stage0.env" <<EOF
FAMILY=synth-bertbase
HF_MODEL_DIR=${HF_DIR}
POOLING=mean
METRIC_DENSE=METRIC_IP
DATA_DIR=${WS}/data
OUT_ROOT=${WS}/experiments/synth
DENSE_STEPS=${DENSE_STEPS:-2000}
DENSE_BATCH=${DENSE_BATCH:-256}
DENSE_LR=${DENSE_LR:-1e-4}
DENSE_EVAL_STEPS=${DENSE_EVAL_STEPS:-200}
CACHE_CHUNK=${CACHE_CHUNK:-128}
EOF
  run_stage "${WS}/stage0.env" 0
  HF_DIR="${WS}/experiments/synth/dense_pretrain/export_hf"
fi

cat > "${WS}/synth.env" <<EOF
FAMILY=synth-bertbase
HF_MODEL_DIR=${HF_DIR}
POOLING=mean
METRIC_DENSE=METRIC_IP
M=48
DATA_DIR=${WS}/data
OUT_ROOT=${WS}/experiments/synth
GLOBAL_BATCH=${GLOBAL_BATCH:-256}
CACHE_CHUNK=${CACHE_CHUNK:-128}
CONC_STEPS=${CONC_STEPS:-800}
JPQ_STEPS=${JPQ_STEPS:-800}
JPQ_BATCH=${JPQ_BATCH:-128}
EVAL_STEPS=${EVAL_STEPS:-100}
MAX_DOC_LEN_EVAL=${MAX_DOC_LEN_EVAL:-128}
IVF=1
NLIST=${NLIST:-1024}
NPROBE=${NPROBE:-32}
EOF

for STAGE in 2 3 4 5 6 7 8 9 10 opq-eval jpq-train jpq-eval; do
  run_stage "${WS}/synth.env" "${STAGE}"
done

echo "=== synthetic bert-base rehearsal metrics ==="
python - <<EOF
import json, os
root = "${WS}/experiments/synth"
for name in ("dense/dev", "m48/conc_index/dev", "m48/jpq_index/dev",
             "m48/opq_index/dev", "m48/jpq_only_index/dev"):
    p = os.path.join(root, name, "metric.json")
    if os.path.exists(p):
        m = json.load(open(p))
        print(f"{name}: MRR@10={m['mrr']['MRR@10']} "
              f"R@100={m['recall']['Recall@100']}")
EOF
