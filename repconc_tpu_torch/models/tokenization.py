"""The port's tokenizers: BERT WordPiece and RoBERTa byte-level BPE.

They stand in for the HF fast tokenizers that the JAX package loads with
`AutoTokenizer` (repconc_tpu/models/adapters.py), read the same files of a
model dir, and give the same `input_ids` and `attention_mask`, id for id,
with the standard library and numpy only:

* `WordPieceTokenizer`, the counterpart of `BertTokenizerFast` (and of
  `DistilBertTokenizerFast`, the same algorithm): every BERT-family dir the
  repo supports (sentence-bert, coCondenser, TAS-B, TCT-ColBERT, the toy and
  synthetic models, the M=12 model). It reads `tokenizer.json` when the dir
  has one, otherwise `vocab.txt` with `tokenizer_config.json`.
* `ByteLevelBPETokenizer`, the counterpart of `RobertaTokenizerFast` (ANCE):
  `tokenizer.json`'s BPE model, or `vocab.json` with `merges.txt`.

The stages follow HF `tokenizers`: added and special tokens are split out of
the raw text first (leftmost-longest, with their lstrip / rstrip flags);
each remaining piece is normalized (WordPiece: `BertNormalizer`), split
into words (`BertPreTokenizer`, or the GPT-2 pattern of `ByteLevel`) and
mapped by the model; then truncation (after the special tokens are
counted), the special tokens and padding. As in HF, `tokenizer_config.json`
overrides `tokenizer.json` on `do_lower_case`, `strip_accents`,
`tokenize_chinese_chars` and `add_prefix_space`.

The character classes are HF's own (`models/unicode_tables.py`), not
`unicodedata`'s: the Rust crates behind `tokenizers` carry older or newer
Unicode tables than Python, and where they differ HF's answer is the one
to give. Decomposition and lower-casing use `unicodedata` with HF's
differences listed in the same module.

Both tokenizers run in the encode's producer thread (eval/encode.py), in
pure Python: each memoises the model's output per word (a plain dict,
cleared when it reaches `memo_limit` entries). `memo_limit = 0` turns the
memo off.
"""
from __future__ import annotations

import bisect
import json
import logging
import os
import re
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

from repconc_tpu_torch.models import unicode_tables as tables

logger = logging.getLogger(__name__)

LARGE_INTEGER = int(1e20)       # transformers' "no model_max_length" cut-off
VERY_LARGE_INTEGER = int(1e30)  # transformers' default model_max_length
MEMO_LIMIT = 1 << 20            # words memoised before the memo is cleared
FAMILIES = ("BERT WordPiece (tokenizer.json WordPiece with BertNormalizer "
            "and BertPreTokenizer, or vocab.txt)",
            "RoBERTa byte-level BPE (tokenizer.json BPE with ByteLevel, or "
            "vocab.json with merges.txt)")
WORDPIECE_FILES = ("tokenizer.json", "vocab.txt", "tokenizer_config.json",
                   "special_tokens_map.json")
BPE_FILES = ("tokenizer.json", "vocab.json", "merges.txt",
             "tokenizer_config.json", "special_tokens_map.json")
# transformers' class for each config.json model_type, for dirs whose
# tokenizer_config.json names no tokenizer_class
MODEL_TYPE_CLASS = {"bert": "BertTokenizerFast",
                    "distilbert": "DistilBertTokenizerFast",
                    "roberta": "RobertaTokenizerFast"}
CHINESE = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
           (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
           (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


# -- character classes --------------------------------------------------------

def _char_class(ranges, negate: bool = False) -> str:
    """A regex character class over inclusive code point ranges."""
    esc = lambda cp: f"\\U{cp:08x}"  # noqa: E731
    body = "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in ranges)
    return f"[{'^' if negate else ''}{body}]"


class _RangeSet:
    """Membership in sorted inclusive code point ranges."""

    def __init__(self, ranges):
        ranges = sorted(ranges)
        self._starts = [a for a, _ in ranges]
        self._ends = [b for _, b in ranges]

    def __contains__(self, cp: int) -> bool:
        i = bisect.bisect_right(self._starts, cp) - 1
        return i >= 0 and cp <= self._ends[i]


_CONTROL = _RangeSet(tables.CONTROL)
_WHITESPACE = frozenset(chr(cp) for lo, hi in tables.WHITESPACE
                        for cp in range(lo, hi + 1))
_MARK_NONSPACING = _RangeSet(tables.MARK_NONSPACING)
_CCC_ZERO = _RangeSet(tables.CCC_ZERO)
_CHINESE = _RangeSet(CHINESE)
_WS = _char_class(tables.WHITESPACE)[1:-1]
_PUNCT = _char_class(tables.PUNCTUATION)[1:-1]
_LETTER = _char_class(tables.LETTER)[1:-1]
_NUMBER = _char_class(tables.NUMBER)[1:-1]
# BertPreTokenizer: whitespace splits, and each punctuation char is a word
_BERT_WORDS = re.compile(f"[^{_WS}{_PUNCT}]+|[{_PUNCT}]")
# the GPT-2 pattern of ByteLevel, with \s, \p{L} and \p{N} as HF's tables
_BYTE_LEVEL_WORDS = re.compile(
    f"'s|'t|'re|'ve|'m|'ll|'d| ?[{_LETTER}]+| ?[{_NUMBER}]+"
    f"| ?[^{_WS}{_LETTER}{_NUMBER}]+|[{_WS}]+(?![^{_WS}])|[{_WS}]+")
# clean_text on ASCII: Cc but tab, newline and CR dropped; those three a space
_ASCII_CLEAN = {**{c: None for c in range(32) if c not in (9, 10, 13)},
                127: None, 9: 32, 10: 32, 13: 32}

if unicodedata.unidata_version != tables.UNIDATA_VERSION:
    logger.warning("unicodedata %s, but the tokenizer tables were taken "
                   "against %s: text with characters assigned since may "
                   "tokenize unlike HF's", unicodedata.unidata_version,
                   tables.UNIDATA_VERSION)


def _nfd(text: str) -> str:
    """Canonical decomposition with HF's decompositions and combining
    classes (unicode_tables.NFD, CCC_ZERO), then canonical ordering."""
    chars = []
    for c in text:
        d = tables.NFD.get(ord(c))
        chars.extend(d if d is not None else unicodedata.normalize("NFD", c))
    ccc = [0 if ord(c) in _CCC_ZERO else unicodedata.combining(c) for c in chars]
    i, n = 0, len(chars)
    while i < n:
        if ccc[i] == 0:
            i += 1
            continue
        j = i
        while j < n and ccc[j] != 0:
            j += 1
        if j - i > 1:
            order = sorted(range(i, j), key=lambda k: ccc[k])  # stable
            chars[i:j] = [chars[k] for k in order]
            ccc[i:j] = [ccc[k] for k in order]
        i = j
    return "".join(chars)


def _lower(text: str) -> str:
    """Per-character lower case, as Rust's char::to_lowercase (no final
    sigma rule), with HF's differences from unicodedata."""
    return "".join(tables.LOWER.get(ord(c)) or c.lower() for c in text)


class BertNormalizer:
    """HF `tokenizers`' BertNormalizer: clean_text drops U+0000, U+FFFD and
    control and format characters (HF's table) and maps whitespace to a
    space; CJK ideographs are padded with spaces; accents are stripped (NFD,
    then every nonspacing mark dropped) when strip_accents says so, or,
    when it is None, when lowercase is on; then per-character lower case."""

    def __init__(self, clean_text=True, handle_chinese_chars=True,
                 strip_accents=None, lowercase=True):
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars
        self.strip_accents = lowercase if strip_accents is None else strip_accents
        self.lowercase = lowercase

    def __call__(self, text: str) -> str:
        if text.isascii():  # nothing to strip, no CJK, lower() is per char
            if self.clean_text:
                text = text.translate(_ASCII_CLEAN)
            return text.lower() if self.lowercase else text
        if self.clean_text:
            text = "".join(" " if c in _WHITESPACE else c for c in text
                           if ord(c) not in _CONTROL)
        if self.handle_chinese_chars:
            text = "".join(f" {c} " if ord(c) in _CHINESE else c for c in text)
        if self.strip_accents:
            text = "".join(c for c in _nfd(text)
                           if ord(c) not in _MARK_NONSPACING)
        return _lower(text) if self.lowercase else text


def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes onto printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# -- files ---------------------------------------------------------------------

def _read_json(path: str) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _token_content(tok) -> Optional[str]:
    return tok.get("content") if isinstance(tok, dict) else tok


class AddedToken:
    """One of HF's added tokens: matched in the text before the model runs,
    on the raw text (normalized=False) or on the normalized pieces."""

    def __init__(self, content: str, id: int, special: bool = True,
                 lstrip: bool = False, rstrip: bool = False,
                 single_word: bool = False, normalized: Optional[bool] = None):
        self.content, self.id, self.special = content, id, special
        self.lstrip, self.rstrip, self.single_word = lstrip, rstrip, single_word
        self.normalized = (not special) if normalized is None else normalized


class _Tokenizer:
    """What both families share: the added-token split, the per-word memo,
    truncation, special tokens, padding, the files, the HF call
    convention. A subclass supplies `_normalize`, `_split_words` and
    `_model`."""

    FAMILY_CLASS = ""   # HF's fast class of the family
    ADAPTER_CLASS: Optional[str] = None  # an adapter's class, whatever the dir
    FILES: Tuple[str, ...] = ()
    DEFAULT_SPECIALS: Dict[str, str] = {}

    def __init__(self, vocab: Dict[str, int], added: List[AddedToken],
                 specials: Dict[str, str], prefix: List[str],
                 suffix: List[str], model_max_length: int, files: Dict[str, bytes],
                 hf_class_name: str):
        self.vocab = dict(vocab)
        self.vocab_size = len(self.vocab)
        self.added_tokens = {}
        for tok in added:  # the first of each content wins
            self.added_tokens.setdefault(tok.content, tok)
        self._full_vocab = dict(self.vocab)
        for tok in self.added_tokens.values():
            self._full_vocab.setdefault(tok.content, tok.id)
        self.special_tokens = dict(specials)
        for name in self.DEFAULT_SPECIALS:  # None where the dir has none
            setattr(self, name, specials.get(name))
        self._prefix = [self._full_vocab[t] for t in prefix]
        self._suffix = [self._full_vocab[t] for t in suffix]
        self.model_max_length = model_max_length
        self._files = files
        # the HF class this tokenizer stands for: its fingerprint's name
        self.hf_class_name = self.ADAPTER_CLASS or hf_class_name
        self._raw_split = self._splitter(False)
        self._normalized_split = self._splitter(True)
        self._memo: Dict[str, Tuple[int, ...]] = {}
        self.memo_limit = MEMO_LIMIT

    @property
    def pad_token_id(self) -> Optional[int]:
        pad = self.special_tokens.get("pad_token")
        return None if pad is None else self._full_vocab.get(pad)

    def get_vocab(self) -> Dict[str, int]:
        """The model's vocab with the added tokens, as HF's get_vocab."""
        return dict(self._full_vocab)

    # -- the added-token split ----------------------------------------------
    def _splitter(self, normalized: bool):
        toks = [t for t in self.added_tokens.values() if t.normalized == normalized]
        if not toks:
            return None
        contents = [self._normalize(t.content) if normalized else t.content
                    for t in toks]
        by_content = dict(zip(contents, toks))
        # leftmost, then longest: the alternation tries longer tokens first
        pattern = re.compile("|".join(re.escape(c) for c in sorted(
            by_content, key=len, reverse=True) if c))
        return pattern, by_content

    @staticmethod
    def _is_word_char(c: str) -> bool:
        return c.isalnum() or c == "_"

    def _split_added(self, text: str, splitter):
        """[(added token or None, piece)], as tokenizers' AddedVocabulary
        find_matches: lstrip / rstrip swallow the whitespace beside a
        match, single_word tokens match only between non-word chars."""
        if splitter is None or not text:
            return [(None, text)]
        pattern, by_content = splitter
        out, offset = [], 0
        for m in pattern.finditer(text):
            tok = by_content[m.group()]
            start, stop = m.start(), m.end()
            if tok.single_word and (
                    (start > 0 and self._is_word_char(text[start - 1]))
                    or (stop < len(text) and self._is_word_char(text[stop]))):
                continue
            if tok.lstrip:
                s = start
                while s > 0 and text[s - 1] in _WHITESPACE:
                    s -= 1
                start = max(s, offset)
            if tok.rstrip:
                while stop < len(text) and text[stop] in _WHITESPACE:
                    stop += 1
            if offset < start:
                out.append((None, text[offset:start]))
            out.append((tok, text[start:stop]))
            offset = stop
        if offset < len(text):
            out.append((None, text[offset:]))
        return out

    def _encode_text(self, text: str) -> List[int]:
        """The ids of one text, without special tokens or truncation."""
        ids: List[int] = []
        memo, model = self._memo, self._model
        for tok, piece in self._split_added(text, self._raw_split):
            if tok is not None:
                ids.append(tok.id)
                continue
            normed = self._normalize(piece)
            for tok2, sub in self._split_added(normed, self._normalized_split):
                if tok2 is not None:
                    ids.append(tok2.id)
                    continue
                for word in self._split_words(sub):
                    got = memo.get(word)
                    if got is None:
                        got = model(word)
                        if self.memo_limit:
                            if len(memo) >= self.memo_limit:
                                memo.clear()
                            memo[word] = got
                    ids.extend(got)
        return ids

    def convert_ids_to_tokens(self, ids):
        inv = {i: t for t, i in self._full_vocab.items()}
        return inv[ids] if isinstance(ids, int) else [inv[i] for i in ids]

    def __call__(self, text, padding=False, truncation=None,
                 max_length: Optional[int] = None,
                 add_special_tokens: bool = True):
        """HF's __call__ for a str or a list of str: input_ids and
        attention_mask as lists. padding True / "longest" pads to the
        longest row, "max_length" to max_length; truncation True /
        "longest_first" cuts each row so that it and its special tokens fit
        max_length (the model_max_length when it is None; max_length alone
        also truncates, as in transformers)."""
        single = isinstance(text, str)
        texts = [text] if single else list(text)
        if max_length is not None and padding is False and truncation is None:
            truncation = True
        pad_mode = {False: None, "do_not_pad": None, True: "longest",
                    "longest": "longest", "max_length": "max_length"}[padding]
        truncate = truncation not in (None, False, "do_not_truncate")
        if truncate and truncation not in (True, "longest_first", "only_first"):
            raise ValueError(f"truncation={truncation!r} is not supported")
        if max_length is None:
            if self.model_max_length > LARGE_INTEGER:
                truncate = False
                if pad_mode == "max_length":
                    pad_mode = None
            else:
                max_length = self.model_max_length
        prefix = self._prefix if add_special_tokens else []
        suffix = self._suffix if add_special_tokens else []
        rows = []
        for t in texts:
            ids = self._encode_text(t)
            if truncate:
                ids = ids[:max(max_length - len(prefix) - len(suffix), 0)]
            rows.append(prefix + ids + suffix)
        if pad_mode is not None:
            pad_id = self.pad_token_id
            if pad_id is None:
                raise ValueError("asked to pad, but the tokenizer has no pad token")
            width = (max_length if pad_mode == "max_length"
                     else max((len(r) for r in rows), default=0))
            masks = [[1] * len(r) + [0] * (width - len(r)) for r in rows]
            rows = [r + [pad_id] * (width - len(r)) for r in rows]
        else:
            masks = [[1] * len(r) for r in rows]
        if single:
            return {"input_ids": rows[0], "attention_mask": masks[0]}
        return {"input_ids": rows, "attention_mask": masks}

    # -- files -----------------------------------------------------------------
    def save_pretrained(self, save_directory: str) -> Tuple[str, ...]:
        """Write the tokenizer files this tokenizer was read from, with a
        tokenizer_config.json that names its class, so that HF's
        AutoTokenizer and both packages read the dir back to the same ids."""
        os.makedirs(save_directory, exist_ok=True)
        written = []
        for name, blob in self._files.items():
            path = os.path.join(save_directory, name)
            with open(path, "wb") as f:
                f.write(blob)
            written.append(path)
        return tuple(written)

    @classmethod
    def _read_files(cls, model_dir: str) -> Dict[str, bytes]:
        files = {}
        for name in cls.FILES:
            path = os.path.join(model_dir, name)
            if os.path.exists(path):
                with open(path, "rb") as f:
                    files[name] = f.read()
        config = json.loads(files.get("tokenizer_config.json", b"{}"))
        if "tokenizer_class" not in config:
            # HF's save_pretrained always names the class; a model dir
            # written without config.json needs it to be read back
            config["tokenizer_class"] = class_name(
                model_dir, cls.FAMILY_CLASS)[:-len("Fast")]
            files["tokenizer_config.json"] = json.dumps(
                config, indent=2, ensure_ascii=False).encode("utf-8") + b"\n"
        return files

    @classmethod
    def _specials(cls, config: dict) -> Dict[str, str]:
        out = {}
        for name, default in cls.DEFAULT_SPECIALS.items():
            content = _token_content(config.get(name, default))
            if content is not None:
                out[name] = content
        return out

    @staticmethod
    def _added_tokens(tok_json: dict, config: dict, specials: Dict[str, str],
                      vocab: Dict[str, int], special_flags: Dict[str, dict]):
        """tokenizer.json's added_tokens, then tokenizer_config.json's
        added_tokens_decoder, then every special token not yet added (as
        transformers adds them, with the family's flags; a token outside the
        vocab takes the next free id)."""
        added = []
        for t in tok_json.get("added_tokens", []):
            added.append(AddedToken(t["content"], t["id"], t.get("special", False),
                                    t.get("lstrip", False), t.get("rstrip", False),
                                    t.get("single_word", False),
                                    t.get("normalized", True)))
        for idx, t in sorted(config.get("added_tokens_decoder", {}).items(),
                             key=lambda kv: int(kv[0])):
            added.append(AddedToken(t["content"], int(idx), t.get("special", False),
                                    t.get("lstrip", False), t.get("rstrip", False),
                                    t.get("single_word", False),
                                    t.get("normalized", not t.get("special", False))))
        seen = {t.content for t in added}
        next_id = max(list(vocab.values()) + [t.id for t in added] + [-1]) + 1
        for content in dict.fromkeys(specials.values()):
            if content in seen:
                continue
            if content in vocab:
                idx = vocab[content]
            else:
                idx, next_id = next_id, next_id + 1
            added.append(AddedToken(content, idx, True,
                                    **special_flags.get(content, {})))
            seen.add(content)
        return added

    @staticmethod
    def _post_processor(tok_json: dict, specials: Dict[str, str],
                        default: Tuple[str, str]) -> Tuple[List[str], List[str]]:
        """The special tokens around a single sequence: TemplateProcessing's
        single template, BertProcessing's or RobertaProcessing's cls / sep,
        none for a null post-processor; the family's (cls, sep) when there
        is no tokenizer.json (the slow-to-fast conversion's)."""
        if not tok_json:
            cls_tok, sep_tok = default
            return [specials[cls_tok]], [specials[sep_tok]]
        post = tok_json.get("post_processor")
        if post is None:
            return [], []
        kind = post.get("type")
        if kind in ("BertProcessing", "RobertaProcessing"):
            return [post["cls"][0]], [post["sep"][0]]
        if kind == "TemplateProcessing":
            prefix, suffix, seen_seq = [], [], False
            for item in post["single"]:
                if "Sequence" in item:
                    seen_seq = True
                    continue
                tokens = post["special_tokens"][item["SpecialToken"]["id"]]["tokens"]
                (suffix if seen_seq else prefix).extend(tokens)
            return prefix, suffix
        raise ValueError(f"post_processor {kind!r} is not supported")


def class_name(model_dir: str, default: str) -> str:
    """The HF fast class AutoTokenizer gives for `model_dir`:
    tokenizer_config.json's tokenizer_class (with "Fast"), else
    config.json's model_type's, else `default`."""
    config = _read_json(os.path.join(model_dir, "tokenizer_config.json"))
    name = config.get("tokenizer_class")
    if name:
        return name if name.endswith("Fast") else name + "Fast"
    model_type = _read_json(os.path.join(model_dir, "config.json")).get("model_type")
    return MODEL_TYPE_CLASS.get(model_type, default)


class WordPieceTokenizer(_Tokenizer):
    """BERT's WordPiece tokenizer (HF `BertTokenizerFast`)."""

    FAMILY_CLASS = "BertTokenizerFast"
    FILES = WORDPIECE_FILES
    DEFAULT_SPECIALS = {"unk_token": "[UNK]", "sep_token": "[SEP]",
                        "pad_token": "[PAD]", "cls_token": "[CLS]",
                        "mask_token": "[MASK]"}

    def __init__(self, vocab, added, specials, prefix, suffix,
                 model_max_length, files, normalizer: Optional[BertNormalizer],
                 unk_token: str = "[UNK]", continuing_subword_prefix: str = "##",
                 max_input_chars_per_word: int = 100,
                 hf_class_name: str = "BertTokenizerFast"):
        self._normalizer = normalizer
        self.continuing_subword_prefix = continuing_subword_prefix
        self.max_input_chars_per_word = max_input_chars_per_word
        super().__init__(vocab, added, specials, prefix, suffix,
                         model_max_length, files, hf_class_name)
        # the model's own unk token, which raises in HF when it is missing
        self._unk = (self.vocab[unk_token],) if unk_token in self.vocab else ()

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "WordPieceTokenizer":
        config = _read_json(os.path.join(model_dir, "tokenizer_config.json"))
        config = {**_read_json(os.path.join(model_dir,
                                            "special_tokens_map.json")), **config}
        tok_json = _read_json(os.path.join(model_dir, "tokenizer.json"))
        specials = cls._specials(config)
        # BertTokenizerFast's arguments override tokenizer.json's normalizer
        lowercase = config.get("do_lower_case", True)
        strip = config.get("strip_accents", None)
        chinese = config.get("tokenize_chinese_chars", True)
        if tok_json:
            model = tok_json["model"]
            if model.get("type") != "WordPiece":
                raise ValueError(
                    f"{model_dir}: tokenizer.json model {model.get('type')!r} "
                    f"is not WordPiece; the port reads {' and '.join(FAMILIES)}")
            norm = tok_json.get("normalizer")
            if norm is not None and norm.get("type") != "BertNormalizer":
                raise ValueError(f"{model_dir}: normalizer {norm.get('type')!r} "
                                 "is not supported (BertNormalizer or none)")
            pre = tok_json.get("pre_tokenizer")
            if (pre or {}).get("type") != "BertPreTokenizer":
                raise ValueError(f"{model_dir}: pre_tokenizer {pre!r} is not "
                                 "supported (BertPreTokenizer)")
            normalizer = None if norm is None else BertNormalizer(
                norm.get("clean_text", True), chinese, strip, lowercase)
            vocab = model["vocab"]
            unk = model.get("unk_token", "[UNK]")
            prefix = model.get("continuing_subword_prefix", "##")
            max_chars = model.get("max_input_chars_per_word", 100)
        else:
            path = os.path.join(model_dir, "vocab.txt")
            if not os.path.exists(path):
                raise ValueError(f"{model_dir} holds neither tokenizer.json nor "
                                 f"vocab.txt; the port reads {' and '.join(FAMILIES)}")
            if os.path.exists(os.path.join(model_dir, "added_tokens.json")):
                raise ValueError(f"{model_dir}: added_tokens.json without "
                                 "tokenizer.json is not supported")
            with open(path, encoding="utf-8") as f:
                vocab = {}
                for idx, line in enumerate(f):
                    vocab[line.rstrip("\n")] = idx
            normalizer = BertNormalizer(True, chinese, strip, lowercase)
            unk, prefix, max_chars = specials.get("unk_token", "[UNK]"), "##", 100
        added = cls._added_tokens(tok_json, config, specials, vocab, {})
        pre_ids, post_ids = cls._post_processor(tok_json, specials,
                                                ("cls_token", "sep_token"))
        return cls(vocab, added, specials, pre_ids, post_ids,
                   int(config.get("model_max_length", VERY_LARGE_INTEGER)),
                   cls._read_files(model_dir), normalizer, unk, prefix,
                   max_chars, class_name(model_dir, cls.FAMILY_CLASS))

    def _normalize(self, text: str) -> str:
        return text if self._normalizer is None else self._normalizer(text)

    @staticmethod
    def _split_words(text: str) -> List[str]:
        return _BERT_WORDS.findall(text)

    def _model(self, word: str) -> Tuple[int, ...]:
        """Greedy longest-match-first WordPiece; [UNK] for a word over
        max_input_chars_per_word chars or with a piece outside the vocab."""
        vocab = self.vocab
        if len(word) > self.max_input_chars_per_word:
            return self._unk
        ids, start, n = [], 0, len(word)
        while start < n:
            end = n
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = self.continuing_subword_prefix + piece
                idx = vocab.get(piece)
                if idx is not None:
                    ids.append(idx)
                    break
                end -= 1
            else:
                return self._unk
            start = end
        return tuple(ids)


class ByteLevelBPETokenizer(_Tokenizer):
    """RoBERTa's byte-level BPE tokenizer (HF `RobertaTokenizerFast`)."""

    FAMILY_CLASS = "RobertaTokenizerFast"
    FILES = BPE_FILES
    DEFAULT_SPECIALS = {"bos_token": "<s>", "eos_token": "</s>",
                        "sep_token": "</s>", "cls_token": "<s>",
                        "unk_token": "<unk>", "pad_token": "<pad>",
                        "mask_token": "<mask>"}

    def __init__(self, vocab, merges: Sequence[Tuple[str, str]], added,
                 specials, prefix, suffix, model_max_length, files,
                 add_prefix_space: bool = False, unk_token: Optional[str] = None,
                 hf_class_name: str = "RobertaTokenizerFast"):
        self.ranks = {tuple(pair): rank for rank, pair in enumerate(merges)}
        self.add_prefix_space = add_prefix_space
        self._byte_map = bytes_to_unicode()
        self._bpe_unk = unk_token
        super().__init__(vocab, added, specials, prefix, suffix,
                         model_max_length, files, hf_class_name)

    @classmethod
    def from_pretrained(cls, model_dir: str) -> "ByteLevelBPETokenizer":
        config = _read_json(os.path.join(model_dir, "tokenizer_config.json"))
        config = {**_read_json(os.path.join(model_dir,
                                            "special_tokens_map.json")), **config}
        tok_json = _read_json(os.path.join(model_dir, "tokenizer.json"))
        specials = cls._specials(config)
        if tok_json:
            model = tok_json["model"]
            if model.get("type") != "BPE":
                raise ValueError(
                    f"{model_dir}: tokenizer.json model {model.get('type')!r} "
                    f"is not BPE; the port reads {' and '.join(FAMILIES)}")
            pre = tok_json.get("pre_tokenizer") or {}
            if pre.get("type") != "ByteLevel" or not pre.get("use_regex", True):
                raise ValueError(f"{model_dir}: pre_tokenizer {pre!r} is not "
                                 "supported (ByteLevel with its regex)")
            if tok_json.get("normalizer") is not None:
                raise ValueError(f"{model_dir}: a normalizer before byte-level "
                                 "BPE is not supported")
            for key in ("continuing_subword_prefix", "end_of_word_suffix",
                        "dropout"):
                if model.get(key):
                    raise ValueError(f"{model_dir}: BPE {key} is not supported")
            if model.get("byte_fallback") or model.get("ignore_merges"):
                raise ValueError(f"{model_dir}: BPE byte_fallback and "
                                 "ignore_merges are not supported")
            vocab = model["vocab"]
            merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                      for m in model["merges"]]
            unk = model.get("unk_token")
        else:
            paths = [os.path.join(model_dir, n) for n in ("vocab.json", "merges.txt")]
            if not all(os.path.exists(p) for p in paths):
                raise ValueError(f"{model_dir} holds neither tokenizer.json nor "
                                 f"vocab.json with merges.txt; the port reads "
                                 f"{' and '.join(FAMILIES)}")
            vocab = _read_json(paths[0])
            with open(paths[1], encoding="utf-8") as f:
                lines = f.read().split("\n")
            if lines and lines[0].startswith("#version"):
                lines = lines[1:]
            merges = [tuple(ln.split(" ", 1)) for ln in lines if ln]
            unk = None
        mask = specials.get("mask_token")
        flags = {mask: {"lstrip": True}} if mask else {}
        added = cls._added_tokens(tok_json, config, specials, vocab, flags)
        pre_ids, post_ids = cls._post_processor(tok_json, specials,
                                                ("cls_token", "sep_token"))
        return cls(vocab, merges, added, specials, pre_ids, post_ids,
                   int(config.get("model_max_length", VERY_LARGE_INTEGER)),
                   cls._read_files(model_dir),
                   bool(config.get("add_prefix_space", False)), unk,
                   class_name(model_dir, cls.FAMILY_CLASS))

    def _normalize(self, text: str) -> str:
        return text

    def _split_words(self, text: str) -> List[str]:
        if self.add_prefix_space and text and not text.startswith(" "):
            text = " " + text
        byte_map = self._byte_map
        return ["".join(byte_map[b] for b in w.encode("utf-8"))
                for w in _BYTE_LEVEL_WORDS.findall(text)]

    def _model(self, word: str) -> Tuple[int, ...]:
        """BPE: merge the adjacent pair of lowest rank until none has one;
        a symbol outside the vocab is the unk token, or dropped without
        one."""
        symbols = list(word)
        ranks = self.ranks
        while len(symbols) > 1:
            best, best_rank = None, None
            for i in range(len(symbols) - 1):
                r = ranks.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = (symbols[i], symbols[i + 1]), r
            if best is None:
                break
            merged, i = [], 0
            while i < len(symbols):
                if (i < len(symbols) - 1 and symbols[i] == best[0]
                        and symbols[i + 1] == best[1]):
                    merged.append(best[0] + best[1])
                    i += 2
                else:
                    merged.append(symbols[i])
                    i += 1
            symbols = merged
        vocab, ids = self.vocab, []
        for s in symbols:
            idx = vocab.get(s)
            if idx is None and self._bpe_unk is not None:
                idx = vocab.get(self._bpe_unk)
            if idx is not None:
                ids.append(idx)
        return tuple(ids)


def load_tokenizer(model_dir: str):
    """The tokenizer of a model dir: byte-level BPE when tokenizer.json's
    model is BPE or the dir holds vocab.json with merges.txt and no
    vocab.txt, WordPiece otherwise (which raises for any other
    tokenizer.json model)."""
    tok_json = _read_json(os.path.join(model_dir, "tokenizer.json"))
    kind = (tok_json.get("model") or {}).get("type")
    if kind is None:
        bpe = (os.path.exists(os.path.join(model_dir, "merges.txt"))
               and not os.path.exists(os.path.join(model_dir, "vocab.txt")))
        kind = "BPE" if bpe else "WordPiece"
    if kind == "BPE":
        return ByteLevelBPETokenizer.from_pretrained(model_dir)
    return WordPieceTokenizer.from_pretrained(model_dir)

