#!/bin/bash
# The offline end-to-end pipeline (stages 2-10) on the port, on toy data:
# the port's copy of recipes/toy/run_toy.sh at the same settings, with the
# port's data maker (no `transformers`) and driver.
# Usage: DEVICE=cpu bash repconc_tpu_torch/recipes/run_toy.sh [workspace_dir]
# (DEVICE defaults to cuda; CONC_STEPS and JPQ_STEPS, 30 and 20 as in the
# JAX recipe, shorten stages 7 and 9.)
set -eu
WS=${1:-./toy_workspace}
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(cd "${HERE}/../.." && pwd)
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"

python -m repconc_tpu_torch.recipes.make_pipeline_data toy --out_dir "${WS}"

export FAMILY=toy
cat > "${WS}/toy.env" <<ENV
FAMILY=toy
HF_MODEL_DIR=${WS}/models/toy-bert
POOLING=mean
METRIC_DENSE=METRIC_COS
M=8
DATA_DIR=${WS}/data
OUT_ROOT=${WS}/experiments/toy
GLOBAL_BATCH=32
CACHE_CHUNK=-1
CONC_STEPS=${CONC_STEPS:-30}
JPQ_STEPS=${JPQ_STEPS:-20}
MAX_DOC_LEN_EVAL=32
ENV
bash "${HERE}/run_pipeline.sh" "${WS}/toy.env" 2 3 4 5 6 7 8 9 10

echo "=== toy pipeline metrics ==="
python - <<PY
import json
for name in ("dense/dev", "m8/conc_index/dev", "m8/jpq_index/dev"):
    m = json.load(open("${WS}/experiments/toy/" + name + "/metric.json"))
    print(f"{name}: MRR@10={m['mrr']['MRR@10']} R@100={m['recall']['Recall@100']}")
PY
