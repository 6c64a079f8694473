#!/bin/bash
# The held-out-encoder matrix on the PyTorch / CUDA port: the twin of
# recipes/synthetic/round4_heldout.sh, leg for leg and value for value,
# through the port's run_pipeline.sh (python -m repconc_tpu_torch.cli.*,
# --device "${DEVICE}") and make_pipeline_data.py's split-heldout.
#
# Construction: stage 0 converges on queries from HALF the subtopics
# (data_stage0); the quantized pipeline trains AND evaluates on the other
# half (data_task), so the doc encoder is not optimal for the task and
# only the variants that train the doc side (RepCONC, stages 7-10) can
# close the gap; JPQ-only trains the query encoder against frozen
# warm-up codes. Legs at M=12:
#   dense    — stages 2-3: the task-side dense baseline (dense/dev)
#   opq      — OPQ warm-up only (m12/opq_index/dev)
#   jpq_only — stage-2 JPQ on the warm-up codes (m12/jpq_only_index/dev)
#   conc     — RepCONC stage 1 and its eval (m12/conc_index/dev)
#   jpq      — stage 2 on conc's codes (m12/jpq_index/dev)
#
#   DEVICE=cuda|cpu LEGS="dense opq ..." \
#       bash repconc_tpu_torch/recipes/heldout_matrix.sh <src_ws> <ws>
#
# <src_ws> holds data/ (make_pipeline_data.py synth --n_docs 200000, then
# complete-qrels --splits train,dev.small) and models/synth-bert-base.
# Restartable: a .done_<step> marker per step; the pipeline's stages skip
# what exists. artifacts/r5h_export_hf.tar (stage 0) and
# artifacts/r5h_m12_conc_best.tar (stage 7's best checkpoint) are
# extracted into <ws> when present.
#
# Where it departs from round4_heldout.sh:
#   1. It never writes into the repository: no persist_artifacts.sh save,
#      no stage-7 watcher, no git commit of the metrics. Metric files and
#      the table stay under <ws> (<ws>/table.md); the tars are only read.
#      Both workspaces are arguments, with no default (the JAX script's
#      defaults are its host's paths).
#   2. LEGS picks a subset of the legs (default: all five). Split, stage 0
#      and stages 2-5 run for any leg; stage 6 (the hard negatives) only
#      for conc and jpq, whose stage 7 reads them, and the stage-7
#      checkpoint is restored only for them (jpq trains on conc's stage-8
#      codes: list it with conc). LEGS="dense opq" is the CPU's run.
#   3. The exit code reports failures: after a failed step the remaining
#      steps still run, as there (conc8 evaluates stage 7's best
#      checkpoint after a cut stage 7), but the script exits 1.
#   4. The table puts each leg's MRR@10, NDCG@10 and R@100 beside the TPU
#      run's (docs/heldout_r5/*.json).
# It also runs from any directory (the CLIs through PYTHONPATH, not a cd
# into the repository), and DEVICE (default cuda) reaches every CLI that
# takes a device.
set -u
if [ $# -lt 2 ]; then
  echo "usage: bash $0 <src_ws> <ws>" >&2
  exit 2
fi
SRC=$1
WS=$2
HERE=$(cd "$(dirname "$0")" && pwd)
PIPE="${HERE}/run_pipeline.sh"
REPO=$(cd "${HERE}/../.." && pwd)
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"
export DEVICE=${DEVICE:-cuda}
LEGS=${LEGS:-dense opq jpq_only conc jpq}
mkdir -p "${WS}"
QLOG="${WS}/queue_log.txt"
FAILED=""
note() { echo "[$(date '+%m-%d %H:%M:%S')] $*" | tee -a "${QLOG}"; }
step() {
  local NAME=$1; shift
  if [ -f "${WS}/.done_${NAME}" ]; then note "skip ${NAME}"; return 0; fi
  note "start ${NAME}"
  local T0=$(date +%s)
  if "$@" >> "${WS}/log_${NAME}.txt" 2>&1; then
    touch "${WS}/.done_${NAME}"
    note "done ${NAME} ($(( $(date +%s) - T0 ))s)"
  else
    note "FAIL ${NAME} ($(( $(date +%s) - T0 ))s) — see log_${NAME}.txt"
    return 1
  fi
}
leg() { case " ${LEGS} " in *" $1 "*) return 0;; esac; return 1; }
# extract artifacts/<tag>.tar beside <dir> when <dir> is absent
restore() {
  local TAR="${REPO}/artifacts/$1.tar" DIR=$2
  [ -d "${DIR}" ] && return 0
  [ -f "${TAR}" ] || return 1
  mkdir -p "$(dirname "${DIR}")"
  tar -C "$(dirname "${DIR}")" -xf "${TAR}"
}

step split python -m repconc_tpu_torch.recipes.make_pipeline_data \
  split-heldout "${SRC}/data" "${WS}" || exit 1

HF_DIR="${WS}/experiments/synth/dense_pretrain/export_hf"
if [ ! -f "${WS}/.done_stage0" ] && restore r5h_export_hf "${HF_DIR}"; then
  touch "${WS}/.done_stage0"
  note "stage0 restored from artifacts/r5h_export_hf.tar"
fi
CONC_BEST="${WS}/experiments/synth/m12/conc/best"
if { leg conc || leg jpq; } && [ ! -f "${WS}/.done_conc7" ] \
    && restore r5h_m12_conc_best "${CONC_BEST}"; then
  touch "${WS}/.done_conc7"
  note "conc7 best checkpoint restored from artifacts/r5h_m12_conc_best.tar" \
    "— skipping retrain"
fi

cat > "${WS}/stage0.env" <<EOF
FAMILY=synth-heldout
HF_MODEL_DIR=${SRC}/models/synth-bert-base
POOLING=mean
METRIC_DENSE=METRIC_IP
DATA_DIR=${WS}/data_stage0
OUT_ROOT=${WS}/experiments/synth
DENSE_STEPS=2000
DENSE_BATCH=256
DENSE_LR=1e-4
DENSE_EVAL_STEPS=200
CACHE_CHUNK=128
EOF
step stage0 bash "${PIPE}" "${WS}/stage0.env" 0 || exit 1

make_env() {  # make_env <out.env> [extra lines...]
  local OUT=$1; shift
  cat > "${OUT}" <<EOF
FAMILY=synth-heldout
HF_MODEL_DIR=${HF_DIR}
POOLING=mean
METRIC_DENSE=METRIC_IP
M=12
DATA_DIR=${WS}/data_task
OUT_ROOT=${WS}/experiments/synth
GLOBAL_BATCH=256
CACHE_CHUNK=128
CONC_STEPS=800
JPQ_STEPS=800
JPQ_BATCH=128
EVAL_STEPS=100
MAX_DOC_LEN_EVAL=128
NLIST=1024
NPROBE=32
MAX_POSITIVES=160
CONC_LR=2e-6
CONC_CENTROID_LR=1e-3
MSE_WEIGHT=0.01
EOF
  printf '%s\n' "$@" >> "${OUT}"
}
# HELDOUT_CONC_STEPS trims the stage-7 budget under wall-clock pressure
make_env "${WS}/m12.env" "CONC_STEPS=${HELDOUT_CONC_STEPS:-800}"

# the task-side dense baseline (stage 3) and the shared artifacts
if leg conc || leg jpq; then
  step shared bash "${PIPE}" "${WS}/m12.env" 2 3 4 5 6 || exit 1
else
  step shared2to5 bash "${PIPE}" "${WS}/m12.env" 2 3 4 5 || exit 1
fi
if leg opq; then
  step opq_eval bash "${PIPE}" "${WS}/m12.env" opq-eval \
    || FAILED="${FAILED} opq"
fi
if leg jpq_only; then
  step jpq_only bash "${PIPE}" "${WS}/m12.env" jpq-train jpq-eval \
    || FAILED="${FAILED} jpq_only"
fi
# conc runs per stage, so that a wall-clock cutoff can stop stage 7
# mid-run (best-by-MRR checkpoints land every EVAL_STEPS; touch .done_conc7
# and rerun to eval the best checkpoint), and the 9/10 stage-2 leg can be
# skipped under time pressure (HELDOUT_RUN_JPQ9=0)
if leg conc; then
  step conc7 bash "${PIPE}" "${WS}/m12.env" 7 || FAILED="${FAILED} conc7"
  step conc8 bash "${PIPE}" "${WS}/m12.env" 8 || FAILED="${FAILED} conc8"
fi
if leg jpq && [ "${HELDOUT_RUN_JPQ9:-1}" = "1" ]; then
  step conc9 bash "${PIPE}" "${WS}/m12.env" 9 || FAILED="${FAILED} conc9"
  step conc10 bash "${PIPE}" "${WS}/m12.env" 10 || FAILED="${FAILED} conc10"
fi

note "heldout matrix complete${FAILED:+ — failed steps:${FAILED}}"
python - "${WS}" "${REPO}/docs/heldout_r5" <<'EOF' | tee "${WS}/table.md"
import json
import os
import sys

ws, tpu_dir = sys.argv[1:]
root = os.path.join(ws, "experiments", "synth")
rows = (("dense (task)", "dense/dev"), ("opq", "m12/opq_index/dev"),
        ("jpq_only", "m12/jpq_only_index/dev"),
        ("repconc", "m12/conc_index/dev"),
        ("repconc+jpq", "m12/jpq_index/dev"))


def three(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        m = json.load(f)
    return (m["mrr"]["MRR@10"], m["ndcg"]["NDCG@10"],
            m["recall"]["Recall@100"])


def cells(v):
    return " | ".join(f"{x:.4f}" for x in v) if v else "(missing) | |"


print("| leg | port MRR@10 | port NDCG@10 | port R@100 "
      "| TPU MRR@10 | TPU NDCG@10 | TPU R@100 |")
print("|---|---|---|---|---|---|---|")
for name, leg in rows:
    port = three(os.path.join(root, leg, "metric.json"))
    tpu = three(os.path.join(tpu_dir, leg.replace("/", "_") + ".json"))
    print(f"| {name} | {cells(port)} | {cells(tpu)} |")
EOF
[ -z "${FAILED}" ]
