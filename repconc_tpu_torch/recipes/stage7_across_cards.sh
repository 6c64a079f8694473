#!/bin/bash
# Stage 7 of the port's recipe (stage-1 RepCONC training, run_train_conc)
# on one card and across the cards of one host, with its step times.
#
#   bash repconc_tpu_torch/recipes/stage7_across_cards.sh WS [NPROC]
#
# On chip_smoke.py's pipeline_recipe inputs: the synthetic workspace at the
# M=12 model's widths (bert-base, vocab 7,905, mean pooling, M=12, K=256),
# 2 layers and 40,000 docs; stages 2-6 through run_pipeline.sh on one
# device; then the recipe's stage-7 flags (recipes/run_pipeline.sh, stage 7)
# at a global batch of GLOBAL_BATCH queries through cli_step_times: once in
# one process (--data_parallel at world size 1) and once under torchrun
# over NPROC processes (default 4), one GPU each. Each prints one JSON line
# of step times. DOCS, LAYERS, HIDDEN, GLOBAL_BATCH, STEPS and DEVICE
# (cuda, or cpu for gloo ranks) change the defaults.
set -eu
WS=$1
NPROC=${2:-4}
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(cd "${HERE}/../.." && pwd)
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"
export DEVICE=${DEVICE:-cuda}
GLOBAL_BATCH=${GLOBAL_BATCH:-512}
STEPS=${STEPS:-30}

python -m repconc_tpu_torch.recipes.make_pipeline_data synth --out_dir "${WS}" \
    --n_docs "${DOCS:-40000}" --hidden_layers "${LAYERS:-2}" \
    --hidden_size "${HIDDEN:-768}"
cat > "${WS}/synth.env" <<ENV
FAMILY=synth
HF_MODEL_DIR=${WS}/models/synth-bert-base
DATA_DIR=${WS}/data
OUT_ROOT=${WS}/experiments/synth
POOLING=mean
METRIC_DENSE=METRIC_IP
M=12
ENV
bash "${HERE}/run_pipeline.sh" "${WS}/synth.env" 2 3 4 5 6

D=${WS}/data
O=${WS}/experiments/synth
ARGS=(--model_name_or_path "${O}/m12/warmup_model"
      --qrel_path "${D}/qrels.train.tsv" --query_path "${D}/queries.train.tsv"
      --corpus_path "${D}/corpus.tsv"
      --valid_qrel_path "${O}/valid/qrels.tsv"
      --valid_query_path "${O}/valid/queries.tsv"
      --valid_corpus_path "${O}/valid/corpus.tsv"
      --max_query_len 16 --max_doc_len 128
      --per_device_train_batch_size "${GLOBAL_BATCH}"
      --negative "${O}/hardneg.json" --negative_per_query 11
      --max_positives 8 --learning_rate 2e-5 --centroid_learning_rate 5e-4
      --mse_loss_weight 1e-4 --temperature 1 --sk_epsilon 0.003 --sk_iters 100
      --cache_chunk_size 128 --max_steps "${STEPS}" --logging_steps 1
      --eval_steps 100000 --save_steps 100000 --data_parallel
      --device "${DEVICE}")
python -m repconc_tpu_torch.recipes.cli_step_times run_train_conc "${ARGS[@]}" \
    --output_dir "${O}/m12/conc_1"
python -m torch.distributed.run --nproc_per_node "${NPROC}" \
    -m repconc_tpu_torch.recipes.cli_step_times run_train_conc "${ARGS[@]}" \
    --output_dir "${O}/m12/conc_${NPROC}"
