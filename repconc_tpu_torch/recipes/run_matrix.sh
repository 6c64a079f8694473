#!/bin/bash
# Converged-encoder compression matrix on the PyTorch / CUDA port: the twin
# of recipes/synthetic/run_matrix.sh, loop for loop and value for value.
# OPQ-only / JPQ-only / RepCONC / RepCONC+JPQ at M=48 (64x), M=12 (256x)
# and M=4 (768x, the far end of the reference's claimed range), every
# variant starting from the SAME converged dense encoder produced by
# run_synth.sh's stage 0.
#
# Prerequisites: run_synth.sh has completed through stage 6 (shared dense
# embeds, valid sets, hardneg.json). Each M then gets its own warmup
# (stage 5) and the full trained matrix (stages 7-10 + siblings). Every
# eval here is flat (no IVF).
#
# The low-mse legs rerun stages 7-10 with mse_loss_weight=1e-4 (the
# reference's own MS MARCO value, 7_run_conc_train.sh) in a tagged
# experiment dir (EXP_TAG=-lowmse) that shares its base M's warm-up through
# a symlink: the 0.01 anchor used at M=48/12 is miscast at 768x (it
# contributes about 5x the contrastive loss and cannot push the RMSE below
# the 4-subspace floor).
#
#   DEVICE=cuda bash repconc_tpu_torch/recipes/run_matrix.sh <workspace>
#
# Where it departs from recipes/synthetic/run_matrix.sh:
#   1. Every stage runs through the port's run_pipeline.sh beside this
#      script.
#   2. DEVICE (default cuda) is exported, so it reaches every CLI that takes
#      a device.
#   3. MATRIX_M (default "48 12 4") and LOWMSE_M (default "4 12") list the
#      values of M of the two loops, so that a subset runs, as the tests do
#      on the CPU.
# Every artifact of the eval CLI is skip-if-exists and stage 7 resumes from
# its checkpoint, as in the JAX script: over a workspace whose m48/ is
# complete, the M=48 leg redoes little.
set -eu
WS=${1:?workspace (run_synth.sh output)}
HERE=$(cd "$(dirname "$0")" && pwd)
HF_DIR="${WS}/experiments/synth/dense_pretrain/export_hf"
export DEVICE=${DEVICE:-cuda}

make_env() {  # make_env <out.env> <M> [extra lines...]
  local OUT=$1 MM=$2; shift 2
  cat > "${OUT}" <<EOF
FAMILY=synth-bertbase
HF_MODEL_DIR=${HF_DIR}
POOLING=mean
METRIC_DENSE=METRIC_IP
M=${MM}
DATA_DIR=${WS}/data
OUT_ROOT=${WS}/experiments/synth
GLOBAL_BATCH=${GLOBAL_BATCH:-256}
CACHE_CHUNK=${CACHE_CHUNK:-128}
CONC_STEPS=${CONC_STEPS:-800}
JPQ_STEPS=${JPQ_STEPS:-800}
JPQ_BATCH=${JPQ_BATCH:-128}
EVAL_STEPS=100
MAX_DOC_LEN_EVAL=128
NLIST=1024
NPROBE=32
MAX_POSITIVES=160
CONC_LR=2e-6
CONC_CENTROID_LR=1e-3
EOF
  printf '%s\n' "$@" >> "${OUT}"
}

run_stages() {  # run_stages <env> <stage...>
  local ENVF=$1; shift
  for STAGE in "$@"; do
    T0=$(date +%s)
    bash "${HERE}/run_pipeline.sh" "${ENVF}" "${STAGE}"
    echo -e "$(basename "${ENVF}" .env)/${STAGE}\t$(( $(date +%s) - T0 ))s" \
      | tee -a "${WS}/stage_times_matrix.tsv"
  done
}

# Stabilized-config matrices (lr 2e-6 / centroid 1e-3 / mse 0.01 is the
# stable point at M=48/12: the reference's LRs norm-inflate on a saturated
# task).
for MM in ${MATRIX_M:-48 12 4}; do
  make_env "${WS}/matrix_m${MM}.env" "${MM}" "MSE_WEIGHT=0.01"
  run_stages "${WS}/matrix_m${MM}.env" 5 7 8 9 10 opq-eval jpq-train jpq-eval
done

# Low-mse variants (mse_loss_weight=1e-4): each shares its base M's warmup
# (stage 7's only tagged input); the opq/jpq-only siblings are identical to
# the base and are not rerun.
for MM in ${LOWMSE_M:-4 12}; do
  make_env "${WS}/matrix_m${MM}_lowmse.env" "${MM}" \
    "MSE_WEIGHT=1e-4" "EXP_TAG=-lowmse"
  mkdir -p "${WS}/experiments/synth/m${MM}-lowmse"
  ln -sfn "../m${MM}/warmup_model" \
    "${WS}/experiments/synth/m${MM}-lowmse/warmup_model"
  run_stages "${WS}/matrix_m${MM}_lowmse.env" 7 8 9 10
done

echo "=== compression matrix metrics ==="
python - <<EOF
import json, os
root = "${WS}/experiments/synth"
for mm in ("m48", "m12", "m4", "m4-lowmse", "m12-lowmse"):
    for name in ("opq_index/dev", "jpq_only_index/dev", "conc_index/dev",
                 "jpq_index/dev"):
        p = os.path.join(root, mm, name, "metric.json")
        if os.path.exists(p):
            m = json.load(open(p))
            print(f"{mm}/{name}: MRR@10={m['mrr']['MRR@10']} "
                  f"NDCG@10={m['ndcg']['NDCG@10']} "
                  f"R@100={m['recall']['Recall@100']}")
EOF
