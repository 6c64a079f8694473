#!/bin/bash
# One-command MS MARCO-scale rehearsal on the PyTorch / CUDA port: the twin
# of recipes/msmarco_scale_e2e.sh, with recipes/ws8m_pretokenize_bg.sh's
# pretokenize folded in. Generate the corpus, build <ws>/token_cache,
# encode it with a RepCONC model, build the IVF index and serve the dev
# queries through the standard eval CLI (the stage-8 invocation every
# recipe runs; reference: evaluate/run_repconc_eval.py:38-59 at its MS
# MARCO scale). On a card the search is K2's two passes over the probed
# cells and K1's two passes over the spill.
#
# Per-phase wall-clock (corpus load / tokenize / device encode / IVF build /
# search) lands in <ws>/eval/dev/timings.json via the CLI's Stopwatch.
#
# The corpus comes from make_pipeline_data.py synth with the vocabulary of
# the 200,000-doc workspace (the same for every n_docs at the default topic
# geometry), so a model trained on that workspace scores structured codes.
#
# Usage:
#   DEVICE=cuda bash repconc_tpu_torch/recipes/msmarco_scale_e2e.sh \
#       <workspace> <model_dir> [n_docs]
# The pretokenize tokenizes with <model_dir>'s tokenizer (the cache is keyed
# on the tokenizer's vocabulary, the corpus and the length); it is skipped
# when <workspace>/token_cache already holds a cache. DEVICE (default cuda)
# reaches the eval CLI's --device.
set -eu
WS=$1
MODEL=$2
NDOCS=${3:-8800000}
HERE=$(cd "$(dirname "$0")" && pwd)
REPO=$(cd "${HERE}/../.." && pwd)
export PYTHONPATH="${REPO}${PYTHONPATH:+:${PYTHONPATH}}"
DEVICE=${DEVICE:-cuda}

if [ ! -f "${WS}/data/corpus.tsv" ]; then
  python -m repconc_tpu_torch.recipes.make_pipeline_data synth \
    --out_dir "${WS}" --n_docs "${NDOCS}"
fi

if [ ! -f "${WS}/token_cache/token_meta.json" ]; then
  python -m repconc_tpu_torch.cli.run_pretokenize \
    --model_name_or_path "${MODEL}" \
    --corpus_path "${WS}/data/corpus.tsv" \
    --output_dir "${WS}/token_cache" \
    --max_seq_length 128
fi
# the flag is a no-op fallback if the cache is absent or stale (keyed on
# corpus, tokenizer and length)
TOKEN_CACHE_FLAG=""
if [ -f "${WS}/token_cache/token_meta.json" ]; then
  TOKEN_CACHE_FLAG="--token_cache_dir ${WS}/token_cache"
fi

T0=$(date +%s)
python -m repconc_tpu_torch.cli.run_repconc_eval \
    --model_name_or_path "${MODEL}" \
    --corpus_path "${WS}/data/corpus.tsv" \
    --query_path "${WS}/data/queries.dev.small.tsv" \
    --qrel_path "${WS}/data/qrels.dev.small.tsv" \
    --out_corpus_dir "${WS}/eval" \
    --out_query_dir "${WS}/eval/dev" \
    --max_seq_length ${MAX_SEQ_LEN:-128} --topk ${TOPK:-1000} \
    --index_type ivf --nlist ${NLIST:-5000} --nprobe ${NPROBE:-64} \
    --serving ${SERVING:-auto} ${TOKEN_CACHE_FLAG} \
    --device "${DEVICE}"
echo "end-to-end wall: $(( $(date +%s) - T0 ))s"
cat "${WS}/eval/dev/timings.json"
