"""Corpus/query batch encoding (counterpart of repconc_tpu/eval/encode.py).

Batches are tokenized, padded to a bucket length (powers of two up to
max_seq_length, as in the JAX package) and encoded on the device in fp32.
The corpus is sorted longest-first, so bucket transitions are monotone and
padding waste is small. Padding never changes a row's result: padded keys
get the -1e9 additive mask.

Tokenization runs in a producer thread that feeds the device loop through
a bounded queue (encode.py:293-359); `TokenCache` (encode.py:63-204) moves
it offline altogether (cli/run_pretokenize.py). `encode_corpus(cache_dir=)`
flushes the output every `shard_size` docs, so a killed encode resumes from
its last complete shard (encode.py:366-513).

PyTorch runs eagerly, so the JAX package's padding of the last batch to a
fixed shape with copies of its last row (a compile-cache measure) is
dropped, in the online path and in `TokenCache.batch` alike.

Adapter tokenizer protocol: if the tokenizer's __call__ accepts
`input_text_type`, it is passed "query"/"doc".
"""
from __future__ import annotations

import functools
import hashlib
import inspect
import json
import logging
import os
import queue
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repconc_tpu_torch.core.device import resolve_device
from repconc_tpu_torch.core.profiling import Stopwatch
from repconc_tpu_torch.parallel.sharded import sharded_encode

logger = logging.getLogger(__name__)

BUCKETS = (16, 32, 64, 128, 256, 512)
PRODUCER_THREAD = "encode-tokenize"  # the name of encode_texts's producer


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


class TokenCache:
    """Offline tokenization of a corpus (encode.py:63-204), in the JAX
    package's layout, so either package opens a cache the other built:

      ids.npy          (n, max_seq_length), uint16 when the vocab fits, else
                       int32; each row truncated to max_seq_length, and not
                       padded to its batch's width
      lengths.npy      (n,) int32, each row's token count
      token_meta.json  n, max_seq_length, input_text_type, corpus_fp,
                       tokenizer_fp

    `batch` rebuilds `tokenize_batch`'s output for any batch size from the
    lengths: HF pads to the longest row of the batch, and the attention
    mask is a ramp up to each row's length.
    """

    META = "token_meta.json"

    def __init__(self, ids: np.ndarray, lengths: np.ndarray, offset: int = 0):
        self._ids = ids
        self._lengths = lengths
        self._offset = offset

    @staticmethod
    def tokenizer_fingerprint(tokenizer) -> str:
        """sha1 of the class name and the vocab, in id order; the repr of a
        tokenizer without `get_vocab` (encode.py:90-100). The port's
        tokenizers give the name of the HF class each stands for
        (`hf_class_name`), so each package opens the other's cache."""
        name = getattr(tokenizer, "hf_class_name", None) or type(tokenizer).__name__
        h = hashlib.sha1(name.encode())
        try:
            vocab = tokenizer.get_vocab()
            for tok, idx in sorted(vocab.items(), key=lambda kv: kv[1]):
                h.update(f"{tok}\x00{idx}\x01".encode("utf-8", "ignore"))
        except AttributeError:
            h.update(repr(tokenizer).encode("utf-8", "ignore"))
        return h.hexdigest()

    @classmethod
    def _meta(cls, texts, tokenizer, max_seq_length: int,
              input_text_type: str, corpus_fp: Optional[str] = None) -> dict:
        return {"n": len(texts),
                "max_seq_length": int(max_seq_length),
                "input_text_type": input_text_type,
                "corpus_fp": corpus_fp or _corpus_fingerprint(texts),
                "tokenizer_fp": cls.tokenizer_fingerprint(tokenizer)}

    @classmethod
    def build(cls, texts, tokenizer, max_seq_length: int, cache_dir: str,
              input_text_type: str = "doc", chunk: int = 8192,
              corpus_fp: Optional[str] = None,
              verbose: bool = False) -> "TokenCache":
        """Tokenize `texts`, already in encode order, into `cache_dir`. The
        ids go through a `.tmp` memmap renamed when complete."""
        os.makedirs(cache_dir, exist_ok=True)
        meta = cls._meta(texts, tokenizer, max_seq_length, input_text_type,
                         corpus_fp)
        n = len(texts)
        vocab_size = getattr(tokenizer, "vocab_size", None) or (1 << 31) - 1
        dtype = "uint16" if vocab_size < (1 << 16) else "int32"
        ids_path = os.path.join(cache_dir, "ids.npy")
        tmp = ids_path + ".tmp"
        ids_mm = np.lib.format.open_memmap(tmp, mode="w+", dtype=dtype,
                                           shape=(n, max_seq_length))
        lengths = np.zeros((n,), dtype=np.int32)
        for start in range(0, n, chunk):
            batch = list(texts[start:start + chunk])
            bids, bmask = tokenize_batch(tokenizer, batch, max_seq_length,
                                         input_text_type)
            ids_mm[start:start + len(batch), :bids.shape[1]] = bids
            lengths[start:start + len(batch)] = bmask.sum(axis=1)
            if verbose and (start // chunk) % 20 == 0:
                logger.info("pretokenize %d/%d", min(start + chunk, n), n)
        ids_mm.flush()
        del ids_mm
        os.replace(tmp, ids_path)
        np.save(os.path.join(cache_dir, "lengths.npy"), lengths)
        with open(os.path.join(cache_dir, cls.META), "w") as f:
            json.dump(meta, f)
        return cls(np.load(ids_path, mmap_mode="r"), lengths)

    @classmethod
    def open(cls, cache_dir: Optional[str], texts, tokenizer,
             max_seq_length: int, input_text_type: str = "doc",
             corpus_fp: Optional[str] = None) -> Optional["TokenCache"]:
        """The cache in `cache_dir` if it matches (corpus, tokenizer,
        settings) exactly; else None with a warning, and the caller
        tokenizes online: never stale tokens."""
        if cache_dir is None:
            return None
        meta_path = os.path.join(cache_dir, cls.META)
        if not os.path.exists(meta_path):
            logger.warning("token cache %s: not built — tokenizing online",
                           cache_dir)
            return None
        try:
            with open(meta_path) as f:
                have = json.load(f)
            want = cls._meta(texts, tokenizer, max_seq_length,
                             input_text_type, corpus_fp)
            if have != want:
                diff = [k for k in want if have.get(k) != want[k]]
                logger.warning("token cache %s is stale (mismatch: %s) — "
                               "tokenizing online", cache_dir, diff)
                return None
            ids = np.load(os.path.join(cache_dir, "ids.npy"), mmap_mode="r")
            lengths = np.load(os.path.join(cache_dir, "lengths.npy"))
        except (OSError, ValueError, json.JSONDecodeError) as e:
            logger.warning("token cache %s unreadable (%s) — tokenizing "
                           "online", cache_dir, e)
            return None
        logger.info("token cache hit: %s (%d docs)", cache_dir, len(lengths))
        return cls(ids, lengths)

    def slice(self, start: int, stop: int) -> "TokenCache":
        """A view over rows [start, stop), as encode_corpus slices its texts
        per shard; `stop` is implied by the `n` that `batch` is given."""
        return TokenCache(self._ids, self._lengths, offset=self._offset + start)

    def batch(self, start: int, batch_size: int, n: int):
        """Rows [start, min(start + batch_size, n)) of the view (`n` is its
        text count): int64 ids and mask at the batch's longest row, equal to
        `tokenize_batch` on those texts."""
        lo = self._offset + start
        hi = self._offset + min(start + batch_size, n)
        lens = np.asarray(self._lengths[lo:hi])
        width = max(int(lens.max()), 1)
        # one contiguous memmap read: row-by-row indexing is far slower
        ids = np.asarray(self._ids[lo:hi, :width], dtype=np.int64)
        mask = (np.arange(width)[None, :] < lens[:, None]).astype(np.int64)
        return ids, mask


@torch.inference_mode()
def encode_texts(texts, model, tokenizer, max_seq_length: int,
                 batch_size: int = 256, output: str = "continuous_embedding",
                 input_text_type: str = "doc", device="cuda",
                 stopwatch: Stopwatch = None, verbose: bool = False,
                 token_cache: Optional[TokenCache] = None,
                 mesh=None) -> np.ndarray:
    """Encode texts to codes (uint8, output="code") or fp32 embeddings.

    `model` is a RepConcModel already on `device`; it encodes without
    dropout (no generator, models/transformer.py). `token_cache` is a
    TokenCache view aligned with `texts`: the producer reads its batches
    instead of running the tokenizer.

    A daemon producer thread tokenizes and pads each batch into a queue of
    four (encode.py:293-359); this thread uploads, encodes and copies back,
    so every CUDA call stays in the caller's thread. "tokenize" is timed in
    the producer and "device_encode" here: when they overlap, the wall
    clock is near the larger of the two.

    mesh (core/mesh.py): every rank tokenizes the whole batch, encodes its
    contiguous block of it and gathers the blocks
    (parallel/sharded.py::sharded_encode), so every rank returns the whole
    output; the device is the mesh's."""
    if output not in ("code", "continuous_embedding"):
        raise ValueError(f"unknown output {output!r}")
    dev = resolve_device(device) if mesh is None else mesh.device
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
    if output == "code":
        def encode_fn(ids_t, mask_t):
            return model(ids_t, mask_t, return_code=True).discrete_codes
    else:
        encode_fn = model.encode_continuous
    if mesh is not None:
        encode_fn = functools.partial(sharded_encode, mesh, encode_fn)
    q: queue.Queue = queue.Queue(maxsize=4)
    stop = threading.Event()  # the consumer is gone: the producer ends

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.25)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for start in range(0, n, batch_size):
                if stop.is_set():
                    return
                with sw("tokenize"):
                    if token_cache is not None:
                        ids, mask = token_cache.batch(start, batch_size, n)
                    else:
                        ids, mask = tokenize_batch(
                            tokenizer, list(texts[start:start + batch_size]),
                            max_seq_length, input_text_type)
                    ids, mask = pad_to_bucket(ids, mask, max_seq_length,
                                              pad_id)
                if not _put((start, ids, mask)):
                    return
            _put(None)
        except BaseException as e:  # re-raised in the consumer
            _put(e)

    outs = []
    t = threading.Thread(target=producer, name=PRODUCER_THREAD, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            start, ids, mask = item
            with sw("device_encode"):
                res = encode_fn(torch.from_numpy(ids).to(dev),
                                torch.from_numpy(mask).to(dev))
                if output == "code":
                    res = res.to(torch.uint8)
                outs.append(res.cpu().numpy())
            if verbose and (start // batch_size) % 50 == 0:
                logger.info("encoded %d/%d", min(start + batch_size, n), n)
    finally:
        # a failed encode must not leave the producer blocked on a full queue
        stop.set()
        t.join(timeout=30)
    if verbose:
        logger.info("encode phase split: %s",
                    {k: round(v, 2) for k, v in sw.totals.items()})
    return np.concatenate(outs, axis=0)


@torch.no_grad()
def _params_fingerprint(model) -> str:
    """Per tensor of the model's state dict (name, shape, fp64 sum, fp64
    sum of squares), digested: enough to tell checkpoints apart without
    hashing every byte. It is taken over the port's tensors and names, so
    it differs from the JAX package's over the same weights: neither
    package reads the other's shard dirs."""
    h = hashlib.sha1()
    for name, t in sorted(model.state_dict().items()):
        a = t.detach().double()
        # full double precision: a few tiny-lr steps change a sum below
        # 1e-7 relative, and %.17e round-trips it
        h.update(f"{name}|{tuple(t.shape)}|{float(a.sum()):.17e}|"
                 f"{float((a * a).sum()):.17e}".encode())
    return h.hexdigest()


def _corpus_fingerprint(texts) -> str:
    """Content hash of the (length-sorted) texts: any document edit shows,
    also one that keeps n and the boundary ids."""
    h = hashlib.sha1()
    for t in texts:
        h.update(t.encode("utf-8", "ignore"))
        h.update(b"\x00")
    return h.hexdigest()


def _shard_names(cache_dir: str):
    return [n for n in os.listdir(cache_dir)
            if n.startswith(("shard_", ".shard_"))]


def encode_corpus(corpus: Dict[Any, str], model, tokenizer, max_seq_length: int,
                  batch_size: int = 256, output: str = "code", device="cuda",
                  stopwatch: Stopwatch = None, cache_dir: Optional[str] = None,
                  shard_size: int = 262144,
                  token_cache_dir: Optional[str] = None, mesh=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a {docid: text} corpus longest-first (encode.py:399-513).
    Returns (codes_or_embeds, corpus_ids).

    token_cache_dir: a TokenCache of this corpus (cli/run_pretokenize.py),
    opened at the length encode_texts tokenizes at; on a miss the corpus is
    tokenized online.

    cache_dir: shard-level resume. The output is flushed to
    cache_dir/shard_NNNNNN.npy every `shard_size` docs (tmp + rename), and a
    rerun trusts every complete shard. meta.json (n, output, max_seq_length,
    shard_size, the boundary ids, the params and corpus fingerprints, the
    activation dtype, which changes the output at equal params) drops
    every shard when any of them changes. The batch size is not in it: the
    output does not depend on it, and rerunning with a smaller batch after
    running out of memory must keep the finished shards.

    mesh: every rank encodes its block of each batch (encode_texts) and
    returns the whole output; rank 0 alone writes cache_dir, and the other
    ranks wait at a barrier before they read it."""
    corpus_ids = np.array(sorted(corpus, key=lambda k: len(corpus[k]),
                                 reverse=True))
    texts = [corpus[cid] for cid in corpus_ids]
    corpus_fp = _corpus_fingerprint(texts)
    enc_cfg = model.config.encoder
    token_cache = TokenCache.open(
        token_cache_dir, texts, tokenizer,
        min(max_seq_length,
            enc_cfg.max_position_embeddings - enc_cfg.position_offset),
        input_text_type="doc", corpus_fp=corpus_fp)

    def encode(start, stop):
        return encode_texts(texts[start:stop], model, tokenizer,
                            max_seq_length, batch_size, output=output,
                            input_text_type="doc", device=device,
                            stopwatch=stopwatch, verbose=True,
                            token_cache=None if token_cache is None
                            else token_cache.slice(start, stop), mesh=mesh)

    n = len(texts)
    if cache_dir is None:
        return encode(0, n), corpus_ids
    meta = {"n": n, "output": output, "max_seq_length": max_seq_length,
            "shard_size": shard_size,
            "first_id": str(corpus_ids[0]) if n else None,
            "last_id": str(corpus_ids[-1]) if n else None,
            "params_fp": _params_fingerprint(model),
            "dtype": enc_cfg.dtype,
            "corpus_fp": corpus_fp}
    writer = mesh is None or mesh.is_main
    if writer:
        os.makedirs(cache_dir, exist_ok=True)
        meta_path = os.path.join(cache_dir, "meta.json")
        try:
            with open(meta_path) as f:
                stale = json.load(f) != meta
        except (OSError, json.JSONDecodeError):
            stale = True
        if stale:
            for name in _shard_names(cache_dir):
                os.remove(os.path.join(cache_dir, name))
            with open(meta_path, "w") as f:
                json.dump(meta, f)
    if mesh is not None:
        mesh.barrier()  # every rank sees the same finished shards
    if n == 0:
        return encode(0, 0), corpus_ids
    done = {name for name in os.listdir(cache_dir)
            if name.startswith("shard_")}
    out = None  # filled shard by shard: no second copy of the whole output
    for i, start in enumerate(range(0, n, shard_size)):
        path = os.path.join(cache_dir, f"shard_{i:06d}.npy")
        if os.path.basename(path) in done:
            enc = np.load(path)
        else:
            enc = encode(start, start + shard_size)
            if writer:
                tmp = os.path.join(cache_dir, f".shard_{i:06d}.tmp.npy")
                np.save(tmp, enc)
                os.replace(tmp, path)
                logger.info("encode shard %d (%d/%d docs) flushed to %s", i,
                            min(start + shard_size, n), n, path)
        if out is None:
            out = np.empty((n,) + enc.shape[1:], dtype=enc.dtype)
        out[start:start + len(enc)] = enc
    return out, corpus_ids


def clear_encode_cache(cache_dir: Optional[str]) -> None:
    """Remove a shard-resume cache once the final artifact is saved."""
    if cache_dir is None or not os.path.isdir(cache_dir):
        return
    for name in _shard_names(cache_dir) + ["meta.json"]:
        path = os.path.join(cache_dir, name)
        if os.path.exists(path):
            os.remove(path)
    try:
        os.rmdir(cache_dir)
    except OSError:  # something else lives there: leave it
        pass


def encode_queries(queries: Dict[Any, str], model, tokenizer,
                   max_seq_length: int, batch_size: int = 256, device="cuda",
                   stopwatch: Stopwatch = None, mesh=None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Queries to fp32 embeddings, sorted by qid (encode.py:516-532); with
    a mesh, encoded over its ranks (encode_texts)."""
    query_ids = sorted(queries.keys())
    texts = [queries[qid] for qid in query_ids]
    embeds = encode_texts(texts, model, tokenizer, max_seq_length, batch_size,
                          output="continuous_embedding",
                          input_text_type="query", device=device,
                          stopwatch=stopwatch, mesh=mesh)
    return embeds, np.array(query_ids)
