#!/bin/bash
# The RepCONC pipeline on the PyTorch / CUDA port (repconc_tpu_torch): the
# port's copy of recipes/run_pipeline.sh, stage for stage and flag for flag,
# with `python -m repconc_tpu_torch.cli.*` in place of `repconc_tpu.cli.*`
# and `--device "${DEVICE}"` on every CLI that takes a device.
#
#   DEVICE=cuda bash repconc_tpu_torch/recipes/run_pipeline.sh <family.env> <stage...>
#   e.g. bash repconc_tpu_torch/recipes/run_pipeline.sh sentence-bert.env 2 3 4 5 6 7 8 9 10
#
# <family.env> is a path, or the name of one of recipes/*.env. DEVICE is
# cuda (the default; one process, one card) or cpu. Every CLI tokenizes
# with the port's own tokenizers: no `transformers` is needed.
#
# Stages (reference: examples/tas-balanced/README.md:44-72):
#   0  dense contrastive pre-training (exported as an HF dir at
#      ${OUT_ROOT}/dense_pretrain/export_hf; point HF_MODEL_DIR there)
#   1  prepare dataset (MS MARCO passage; needs network: recipes/prepare_msmarco.sh)
#   2  customize dense checkpoint (stamp pooling + similarity metric)
#   3  dense corpus encoding + flat-IP eval (reproduction check + embeds)
#   4  sample validation corpus
#   5  OPQ warmup (rotation + centroids + warmup index)
#   6  mine hard negatives from the dense run
#   7  stage-1 RepCONC joint training
#   8  encode + build PQ index + eval (flat ADC, or IVF with IVF=1)
#   9  stage-2 JPQ training on frozen codes
#   10 eval stage-2 query encoder against stage-8 codes
#
# Sibling recipes (after stages 2-5): opq-eval (the warm-up checkpoint
# evaluated directly), jpq-train (stage-2 JPQ on the warm-up model and
# codes, stage 1 skipped), jpq-eval (jpq-train's query encoder against the
# warm-up codes).
set -eu

CONFIG="$1"; shift
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(cd "${HERE}/../.." && pwd)
if [ -f "${CONFIG}" ]; then
  source "${CONFIG}"
else
  source "${REPO}/recipes/${CONFIG}"
fi
DEVICE=${DEVICE:-cuda}
# the CLIs run as `python -m repconc_tpu_torch.cli.*` from any directory
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"

DATA_DIR=${DATA_DIR:-./data/msmarco-passage}
OUT_ROOT=${OUT_ROOT:-./data/experiments/${FAMILY}}
M=${M:-48}
# Experiment dir for the quantized stages (5-10 + siblings). EXP_TAG lets a
# hyperparameter variant (e.g. EXP_TAG=-lowmse) run stages 7-10 in its own
# directory while sharing the family's stage 2-6 artifacts — symlink
# ${EXP}/warmup_model at the tagged path (stage 7's only tagged input).
EXP=${OUT_ROOT}/m${M}${EXP_TAG:-}
ADAPTER_FLAG=${ADAPTER:+--adapter ${ADAPTER}}
MAX_DOC_LEN_EVAL=${MAX_DOC_LEN_EVAL:-512}

best_or_final() {
  if [ -d "$1/best" ]; then echo "$1/best"; else echo "$1/final"; fi
}

for STAGE in "$@"; do
case $STAGE in
0)
  # bootstrap valid set (no dense run exists yet): judged docs + random pad
  python -m repconc_tpu_torch.cli.run_gen_valid_set \
    --input_corpus_path "${DATA_DIR}/corpus.tsv" \
    --input_query_path "${DATA_DIR}/queries.dev.small.tsv" \
    --input_qrel_path "${DATA_DIR}/qrels.dev.small.tsv" \
    --random_sample ${VALID0_SAMPLE:-5000} \
    --output_corpus_path "${OUT_ROOT}/valid0/corpus.tsv" \
    --output_query_path "${OUT_ROOT}/valid0/queries.tsv" \
    --output_qrel_path "${OUT_ROOT}/valid0/qrels.tsv"
  python -m repconc_tpu_torch.cli.run_train_dense \
    --model_name_or_path "${HF_MODEL_DIR}" ${ADAPTER_FLAG} \
    --output_dir "${OUT_ROOT}/dense_pretrain" \
    --pooling "${POOLING}" --similarity_metric "${METRIC_DENSE:-METRIC_IP}" \
    --qrel_path "${DATA_DIR}/qrels.train.tsv" \
    --query_path "${DATA_DIR}/queries.train.tsv" \
    --corpus_path "${DATA_DIR}/corpus.tsv" \
    --valid_qrel_path "${OUT_ROOT}/valid0/qrels.tsv" \
    --valid_query_path "${OUT_ROOT}/valid0/queries.tsv" \
    --valid_corpus_path "${OUT_ROOT}/valid0/corpus.tsv" \
    --max_query_len ${MAX_QUERY_LEN:-16} --max_doc_len ${MAX_DOC_LEN:-128} \
    --per_device_train_batch_size ${DENSE_BATCH:-256} \
    --negative random --negative_per_query ${DENSE_NEGS:-1} \
    --max_positives ${MAX_POSITIVES:-8} \
    --learning_rate ${DENSE_LR:-1e-4} --warmup_steps ${DENSE_WARMUP:-100} \
    --cache_chunk_size ${CACHE_CHUNK:-128} \
    --max_steps ${DENSE_STEPS:-2000} \
    --logging_steps 20 --eval_steps ${DENSE_EVAL_STEPS:-200} \
    --save_steps ${DENSE_EVAL_STEPS:-200} \
    --data_parallel \
    --device "${DEVICE}"
  ;;
1)
  bash "${REPO}/recipes/prepare_msmarco.sh" "${DATA_DIR}"
  ;;
2)
  python -m repconc_tpu_torch.cli.run_customize_dense \
    --model_name_or_path "${HF_MODEL_DIR}" \
    --similarity_metric "${METRIC_DENSE:-METRIC_IP}" \
    --pooling "${POOLING}" \
    --output_dir "${OUT_ROOT}/dense_model"
  ;;
3)
  python -m repconc_tpu_torch.cli.run_dense_eval \
    --model_name_or_path "${OUT_ROOT}/dense_model" \
    --corpus_path "${DATA_DIR}/corpus.tsv" \
    --query_path "${DATA_DIR}/queries.dev.small.tsv" \
    --qrel_path "${DATA_DIR}/qrels.dev.small.tsv" \
    --out_corpus_dir "${OUT_ROOT}/dense" \
    --out_query_dir "${OUT_ROOT}/dense/dev" \
    --max_seq_length ${MAX_DOC_LEN_EVAL} --topk 200 \
    --save_corpus_embed --save_query_embed ${ADAPTER_FLAG} \
    --device "${DEVICE}"
  ;;
4)
  python -m repconc_tpu_torch.cli.run_gen_valid_set \
    --input_corpus_path "${DATA_DIR}/corpus.tsv" \
    --input_query_path "${DATA_DIR}/queries.dev.small.tsv" \
    --input_qrel_path "${DATA_DIR}/qrels.dev.small.tsv" \
    --input_run_path "${OUT_ROOT}/dense/dev/run.tsv" \
    --topk 100 \
    --output_corpus_path "${OUT_ROOT}/valid/corpus.tsv" \
    --output_query_path "${OUT_ROOT}/valid/queries.tsv" \
    --output_qrel_path "${OUT_ROOT}/valid/qrels.tsv"
  ;;
5)
  python -m repconc_tpu_torch.cli.run_warmup \
    --model_name_or_path "${OUT_ROOT}/dense_model" \
    --MCQ_M ${M} \
    ${METRIC:+--similarity_metric ${METRIC}} \
    --input_corpus_embed_path "${OUT_ROOT}/dense/corpus_embeds.npy" \
    --input_corpus_ids_path "${OUT_ROOT}/dense/corpus_ids.npy" \
    --output_model_dir "${EXP}/warmup_model" \
    --output_index_dir "${EXP}/warmup_index" \
    --device "${DEVICE}"
  ;;
6)
  # retrieve top-200 per TRAIN query with the warmup model, then extract
  # negatives = top-k minus positives (reference: 6_gen_hardneg.sh +
  # train/run_extract_hardneg.py)
  python -m repconc_tpu_torch.cli.run_repconc_eval \
    --model_name_or_path "${EXP}/warmup_model" ${ADAPTER_FLAG} \
    --corpus_path "${DATA_DIR}/corpus.tsv" \
    --query_path "${DATA_DIR}/queries.train.tsv" \
    --out_corpus_dir "${EXP}/warmup_run" \
    --out_query_dir "${EXP}/warmup_run/train" \
    --max_seq_length ${MAX_DOC_LEN_EVAL} --topk 210 \
    --device "${DEVICE}"
  python -m repconc_tpu_torch.cli.run_extract_hardneg \
    --run_path "${EXP}/warmup_run/train/run.tsv" \
    --qrel_path "${DATA_DIR}/qrels.train.tsv" \
    --topk 200 \
    --output_path "${OUT_ROOT}/hardneg.json"
  ;;
7)
  # reference hyperparameters: global batch 4096, 11 hard negatives,
  # lr 2e-5 / centroid-lr 5e-4, mse 1e-4, sk_eps 0.003, sk_iters 100
  # (examples/tas-balanced/repconc/7_run_conc_train.sh:15-20,92-96)
  python -m repconc_tpu_torch.cli.run_train_conc \
    --model_name_or_path "${EXP}/warmup_model" ${ADAPTER_FLAG} \
    --output_dir "${EXP}/conc" \
    --qrel_path "${DATA_DIR}/qrels.train.tsv" \
    --query_path "${DATA_DIR}/queries.train.tsv" \
    --corpus_path "${DATA_DIR}/corpus.tsv" \
    --valid_qrel_path "${OUT_ROOT}/valid/qrels.tsv" \
    --valid_query_path "${OUT_ROOT}/valid/queries.tsv" \
    --valid_corpus_path "${OUT_ROOT}/valid/corpus.tsv" \
    --max_query_len ${MAX_QUERY_LEN:-16} --max_doc_len ${MAX_DOC_LEN:-128} \
    --per_device_train_batch_size ${GLOBAL_BATCH:-4096} \
    --negative "${OUT_ROOT}/hardneg.json" --negative_per_query 11 \
    --max_positives ${MAX_POSITIVES:-8} \
    --learning_rate ${CONC_LR:-2e-5} --centroid_learning_rate ${CONC_CENTROID_LR:-5e-4} \
    --mse_loss_weight ${MSE_WEIGHT:-1e-4} --temperature ${TEMPERATURE:-1} \
    --sk_epsilon 0.003 --sk_iters 100 \
    --cache_chunk_size ${CACHE_CHUNK:-128} \
    --max_steps ${CONC_STEPS:-2000} \
    --logging_steps 20 --eval_steps ${EVAL_STEPS:-40} --save_steps ${EVAL_STEPS:-40} \
    --data_parallel \
    --device "${DEVICE}"
  ;;
8)
  python -m repconc_tpu_torch.cli.run_repconc_eval \
    --model_name_or_path "$(best_or_final "${EXP}/conc")" ${ADAPTER_FLAG} \
    --corpus_path "${DATA_DIR}/corpus.tsv" \
    --query_path "${DATA_DIR}/queries.dev.small.tsv" \
    --qrel_path "${DATA_DIR}/qrels.dev.small.tsv" \
    --out_corpus_dir "${EXP}/conc_index" \
    --out_query_dir "${EXP}/conc_index/dev" \
    --max_seq_length ${MAX_DOC_LEN_EVAL} --topk 1000 \
    ${IVF:+--index_type ivf --nlist ${NLIST:-5000} --nprobe ${NPROBE:-64}} \
    --device "${DEVICE}"
  ;;
9)
  # reference: single-GPU batch 128 (9_run_jpq_train.sh:10-13)
  python -m repconc_tpu_torch.cli.run_train_jpq \
    --model_name_or_path "$(best_or_final "${EXP}/conc")" ${ADAPTER_FLAG} \
    --index_dir "${EXP}/conc_index" \
    --qrel_path "${DATA_DIR}/qrels.train.tsv" \
    --query_path "${DATA_DIR}/queries.train.tsv" \
    --valid_qrel_path "${OUT_ROOT}/valid/qrels.tsv" \
    --valid_query_path "${OUT_ROOT}/valid/queries.tsv" \
    --max_query_len 32 \
    --output_dir "${EXP}/jpq" \
    --per_device_train_batch_size ${JPQ_BATCH:-128} \
    --learning_rate 5e-6 --centroid_learning_rate 2e-4 \
    --dynamic_topk_negative 200 \
    --max_positives ${MAX_POSITIVES:-8} \
    --max_steps ${JPQ_STEPS:-4000} \
    --logging_steps 20 --eval_steps 200 --save_steps 200 \
    --device "${DEVICE}"
  ;;
10)
  python -m repconc_tpu_torch.cli.run_repconc_eval \
    --doc_encoder_path "$(best_or_final "${EXP}/conc")" ${ADAPTER_FLAG} \
    --query_encoder_path "$(best_or_final "${EXP}/jpq")" \
    --corpus_path "${DATA_DIR}/corpus.tsv" \
    --query_path "${DATA_DIR}/queries.dev.small.tsv" \
    --qrel_path "${DATA_DIR}/qrels.dev.small.tsv" \
    --out_corpus_dir "${EXP}/conc_index" \
    --out_query_dir "${EXP}/jpq_index/dev" \
    --max_seq_length ${MAX_DOC_LEN_EVAL} --topk 1000 \
    ${IVF:+--index_type ivf --nlist ${NLIST:-5000} --nprobe ${NPROBE:-64}} \
    --device "${DEVICE}"
  ;;
opq-eval)
  # OPQ-only: score the warmup checkpoint's codes on dev, no finetuning
  python -m repconc_tpu_torch.cli.run_repconc_eval \
    --model_name_or_path "${EXP}/warmup_model" ${ADAPTER_FLAG} \
    --corpus_path "${DATA_DIR}/corpus.tsv" \
    --query_path "${DATA_DIR}/queries.dev.small.tsv" \
    --qrel_path "${DATA_DIR}/qrels.dev.small.tsv" \
    --out_corpus_dir "${EXP}/opq_index" \
    --out_query_dir "${EXP}/opq_index/dev" \
    --max_seq_length ${MAX_DOC_LEN_EVAL} --topk 1000 \
    ${IVF:+--index_type ivf --nlist ${NLIST:-5000} --nprobe ${NPROBE:-64}} \
    --device "${DEVICE}"
  ;;
jpq-train)
  # JPQ-only: stage-2 on the warmup model + warmup codes (stage-1 skipped);
  # reference hyperparameters from examples/tas-balanced/jpq/6_run_jpq_train.sh
  python -m repconc_tpu_torch.cli.run_train_jpq \
    --model_name_or_path "${EXP}/warmup_model" ${ADAPTER_FLAG} \
    --index_dir "${EXP}/warmup_index" \
    --qrel_path "${DATA_DIR}/qrels.train.tsv" \
    --query_path "${DATA_DIR}/queries.train.tsv" \
    --valid_qrel_path "${OUT_ROOT}/valid/qrels.tsv" \
    --valid_query_path "${OUT_ROOT}/valid/queries.tsv" \
    --max_query_len 32 \
    --output_dir "${EXP}/jpq_only" \
    --per_device_train_batch_size ${JPQ_BATCH:-128} \
    --learning_rate 5e-6 --centroid_learning_rate 2e-4 \
    --dynamic_topk_negative 200 \
    --max_positives ${MAX_POSITIVES:-8} \
    --max_steps ${JPQ_STEPS:-4000} \
    --logging_steps 20 --eval_steps 200 --save_steps 200 \
    --device "${DEVICE}"
  ;;
jpq-eval)
  # warmup_index already holds codes.npy/corpus_ids.npy — reused as-is
  # (jpq-train trained against exactly these codes); centroids come from
  # the jpq query encoder (the stage-2 centroid swap).
  python -m repconc_tpu_torch.cli.run_repconc_eval \
    --doc_encoder_path "${EXP}/warmup_model" ${ADAPTER_FLAG} \
    --query_encoder_path "$(best_or_final "${EXP}/jpq_only")" \
    --corpus_path "${DATA_DIR}/corpus.tsv" \
    --query_path "${DATA_DIR}/queries.dev.small.tsv" \
    --qrel_path "${DATA_DIR}/qrels.dev.small.tsv" \
    --out_corpus_dir "${EXP}/warmup_index" \
    --out_query_dir "${EXP}/jpq_only_index/dev" \
    --max_seq_length ${MAX_DOC_LEN_EVAL} --topk 1000 \
    ${IVF:+--index_type ivf --nlist ${NLIST:-5000} --nprobe ${NPROBE:-64}} \
    --device "${DEVICE}"
  ;;
*)
  echo "unknown stage ${STAGE}" >&2; exit 1 ;;
esac
done
