#!/bin/bash
# Zero-shot BEIR-format evaluation of a trained RepCONC model on the
# PyTorch / CUDA port: the twin of recipes/beir_eval.sh (the reference's
# examples/evaluate/repconc_eval_beir.sh), with the same positional
# arguments and the same EVAL_BATCH, MAX_SEQ_LEN, TOPK and IVF knobs.
#
# Usage:
#   DEVICE=cuda bash repconc_tpu_torch/recipes/beir_eval.sh \
#       <dataset_dir> <output_dir> <doc_encoder> [query_encoder]
# <dataset_dir> holds corpus.jsonl, queries.jsonl, qrels/test.tsv (standard
# BEIR layout). If no query encoder is given the doc encoder is used for both.
#
# The port runs one process per GPU, not one SPMD program: DATA_PARALLEL=1
# launches `python -m torch.distributed.run --nproc_per_node ${NPROC}` (NPROC
# defaults to the number of visible GPUs) with --data_parallel, as the
# reference's launcher does. DEVICE (default cuda, or cpu for gloo ranks)
# reaches the CLI's --device.
set -eu
DATASET_DIR=$1
OUTPUT_DIR=$2
DOC_ENCODER=$3
QUERY_ENCODER=${4:-}
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(cd "${HERE}/../.." && pwd)
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"
DEVICE=${DEVICE:-cuda}

mkdir -p "${OUTPUT_DIR}"
if [ -n "${QUERY_ENCODER}" ]; then
  MODEL_ARGS=(--doc_encoder_path "${DOC_ENCODER}"
              --query_encoder_path "${QUERY_ENCODER}")
else
  MODEL_ARGS=(--model_name_or_path "${DOC_ENCODER}")
fi
LAUNCH=(python)
if [ -n "${DATA_PARALLEL:-}" ]; then
  NPROC=${NPROC:-$(python -c "import torch; print(max(torch.cuda.device_count(), 1))")}
  LAUNCH=(python -m torch.distributed.run --nproc_per_node "${NPROC}")
fi

"${LAUNCH[@]}" -m repconc_tpu_torch.cli.run_repconc_eval \
    "${MODEL_ARGS[@]}" \
    --corpus_path "${DATASET_DIR}/corpus.jsonl" \
    --query_path "${DATASET_DIR}/queries.jsonl" \
    --qrel_path "${DATASET_DIR}/qrels/test.tsv" \
    --out_corpus_dir "${OUTPUT_DIR}" \
    --out_query_dir "${OUTPUT_DIR}/test" \
    --data_format beir \
    --per_device_eval_batch_size ${EVAL_BATCH:-64} \
    --max_seq_length ${MAX_SEQ_LEN:-512} \
    --topk ${TOPK:-1000} \
    ${DATA_PARALLEL:+--data_parallel} \
    ${IVF:+--index_type ivf --nlist ${NLIST:-4096} --nprobe ${NPROBE:-64}} \
    --device "${DEVICE}"
