"""Corpus/query batch encoding (counterpart of repconc_tpu/eval/encode.py:
31-60,244-365,399-532).

Batches are tokenized, padded to a bucket length (powers of two up to
max_seq_length, as in the JAX package) and encoded on the device in fp32.
The corpus is sorted longest-first, so bucket transitions are monotone and
padding waste is small. Padding never changes a row's result: padded keys
get the -1e9 additive mask.

Not ported yet: the producer thread that overlaps tokenization with device
work and TokenCache (ROADMAP.md, Queue 1 item 4), and the shard-resumable
corpus cache (item 1a). PyTorch runs eagerly, so the JAX package's padding
of the last batch to a fixed shape (a compile-cache measure) is dropped.

Adapter tokenizer protocol: if the tokenizer's __call__ accepts
`input_text_type`, it is passed "query"/"doc".
"""
from __future__ import annotations

import inspect
import logging
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.core.profiling import Stopwatch

logger = logging.getLogger(__name__)

BUCKETS = (16, 32, 64, 128, 256, 512)


def accepts_text_type(tokenizer) -> bool:
    try:
        return "input_text_type" in inspect.getfullargspec(tokenizer.__call__)[0]
    except TypeError:
        return False


def tokenize_batch(tokenizer, texts, max_length: int, input_text_type: str):
    kwargs = {"input_text_type": input_text_type} if accepts_text_type(tokenizer) else {}
    out = tokenizer(texts, padding=True, truncation=True, max_length=max_length,
                    **kwargs)
    ids = np.asarray(out["input_ids"], dtype=np.int64)
    mask = np.asarray(out["attention_mask"], dtype=np.int64)
    return ids, mask


def pad_to_bucket(ids: np.ndarray, mask: np.ndarray, max_length: int,
                  pad_token_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    L = ids.shape[1]
    bucket = next((b for b in BUCKETS if b >= L and b <= max_length), max_length)
    bucket = min(bucket, max_length)
    if L < bucket:
        ids = np.pad(ids, ((0, 0), (0, bucket - L)), constant_values=pad_token_id)
        mask = np.pad(mask, ((0, 0), (0, bucket - L)))
    elif L > bucket:
        ids, mask = ids[:, :bucket], mask[:, :bucket]
    return ids, mask


@torch.inference_mode()
def encode_texts(texts, model, tokenizer, max_seq_length: int,
                 batch_size: int = 256, output: str = "continuous_embedding",
                 input_text_type: str = "doc", device="cuda",
                 stopwatch: Stopwatch = None, verbose: bool = False
                 ) -> np.ndarray:
    """Encode texts to codes (uint8, output="code") or fp32 embeddings.

    `model` is a RepConcModel already on `device`; it encodes without
    dropout (no generator, models/transformer.py)."""
    if output not in ("code", "continuous_embedding"):
        raise ValueError(f"unknown output {output!r}")
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev != dev:
        raise ValueError(f"model is on {model_dev}, encoding asked for {dev}")
    config = model.config
    limit = config.encoder.max_position_embeddings - config.encoder.position_offset
    if max_seq_length > limit:
        logger.warning("max_seq_length %d exceeds the encoder's position table"
                       " (%d); truncating", max_seq_length, limit)
        max_seq_length = limit
    n = len(texts)
    if n == 0:
        width = config.MCQ_M if output == "code" else config.hidden_size
        return np.zeros((0, width),
                        dtype=np.uint8 if output == "code" else np.float32)
    sw = stopwatch if stopwatch is not None else Stopwatch()
    pad_id = config.encoder.pad_token_id
    outs = []
    for start in range(0, n, batch_size):
        with sw("tokenize"):
            ids, mask = tokenize_batch(tokenizer,
                                       list(texts[start:start + batch_size]),
                                       max_seq_length, input_text_type)
            ids, mask = pad_to_bucket(ids, mask, max_seq_length, pad_id)
        with sw("device_encode"):
            ids_t = torch.from_numpy(ids).to(dev)
            mask_t = torch.from_numpy(mask).to(dev)
            if output == "code":
                res = model(ids_t, mask_t, return_code=True).discrete_codes
                res = res.to(torch.uint8)
            else:
                res = model.encode_continuous(ids_t, mask_t)
            outs.append(res.cpu().numpy())
        if verbose and (start // batch_size) % 50 == 0:
            logger.info("encoded %d/%d", min(start + batch_size, n), n)
    return np.concatenate(outs, axis=0)


def encode_corpus(corpus: Dict[Any, str], model, tokenizer, max_seq_length: int,
                  batch_size: int = 256, output: str = "code", device="cuda",
                  stopwatch: Stopwatch = None) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a {docid: text} corpus longest-first (encode.py:399-450).
    Returns (codes_or_embeds, corpus_ids)."""
    corpus_ids = np.array(sorted(corpus, key=lambda k: len(corpus[k]),
                                 reverse=True))
    texts = [corpus[cid] for cid in corpus_ids]
    enc = encode_texts(texts, model, tokenizer, max_seq_length, batch_size,
                       output=output, input_text_type="doc", device=device,
                       stopwatch=stopwatch, verbose=True)
    return enc, corpus_ids


def encode_queries(queries: Dict[Any, str], model, tokenizer,
                   max_seq_length: int, batch_size: int = 256, device="cuda",
                   stopwatch: Stopwatch = None) -> Tuple[np.ndarray, np.ndarray]:
    """Queries to fp32 embeddings, sorted by qid (encode.py:516-532)."""
    query_ids = sorted(queries.keys())
    texts = [queries[qid] for qid in query_ids]
    embeds = encode_texts(texts, model, tokenizer, max_seq_length, batch_size,
                          output="continuous_embedding",
                          input_text_type="query", device=device,
                          stopwatch=stopwatch)
    return embeds, np.array(query_ids)
