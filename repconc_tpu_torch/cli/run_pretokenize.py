"""Offline corpus tokenization into a TokenCache (counterpart of
repconc_tpu/cli/run_pretokenize.py).

It runs the tokenizer over the corpus ahead of time, in any idle CPU
window, so that `run_repconc_eval --token_cache_dir` and `run_dense_eval
--token_cache_dir` encode without tokenizing. The cache is keyed on the
corpus, the tokenizer, the clamped max length and the text type; at encode
time a mismatch tokenizes online with a warning, never with stale tokens.
The layout is the JAX package's, so either package reads a cache the other
wrote.

  python -m repconc_tpu_torch.cli.run_pretokenize \\
      --model_name_or_path <model dir>  (tokenizer + position-table clamp) \\
      --corpus_path corpus.tsv --max_seq_length 128 \\
      --output_dir <ws>/token_cache [--adapter ance]

No device is used.
"""
from __future__ import annotations

import argparse
import json
import logging
import os

from repconc_tpu_torch.core.config import RepConcConfig
from repconc_tpu_torch.eval.encode import TokenCache
from repconc_tpu_torch.eval.run_io import load_corpus

logger = logging.getLogger(__name__)


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--model_name_or_path", required=True)
    p.add_argument("--corpus_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_seq_length", type=int, default=512)
    p.add_argument("--adapter", default=None)
    p.add_argument("--chunk", type=int, default=8192)
    return p


def position_limit(model_dir: str):
    """(longest input the encoder's position table takes, model_type) of a
    RepCONC model dir or a raw HF dir."""
    try:
        enc = RepConcConfig.load(model_dir).encoder
    except (OSError, ValueError):  # a raw HF dir (a dense checkpoint)
        from repconc_tpu_torch.models.auto import encoder_config_from_hf

        with open(os.path.join(model_dir, "config.json")) as f:
            enc = encoder_config_from_hf(json.load(f))
    return enc.max_position_embeddings - enc.position_offset, enc.model_type


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from repconc_tpu_torch.models.adapters import load_adapter_tokenizer

    limit, model_type = position_limit(args.model_name_or_path)
    tokenizer = load_adapter_tokenizer(args.model_name_or_path,
                                       args.adapter or model_type)
    corpus = load_corpus(args.corpus_path, tokenizer.sep_token)
    # encode_corpus's order exactly: longest text first, stable over ties
    corpus_ids = sorted(corpus, key=lambda k: len(corpus[k]), reverse=True)
    texts = [corpus[cid] for cid in corpus_ids]
    # the clamp encode_texts applies before it tokenizes
    max_len = min(args.max_seq_length, limit)
    logger.info("pretokenizing %d docs at max_len %d -> %s", len(texts),
                max_len, args.output_dir)
    TokenCache.build(texts, tokenizer, max_len, args.output_dir,
                     input_text_type="doc", chunk=args.chunk, verbose=True)
    logger.info("token cache written: %s", args.output_dir)


if __name__ == "__main__":
    main()
