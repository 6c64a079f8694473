"""The port's tokenizers (repconc_tpu_torch/models/tokenization.py) against
HF's fast tokenizers, which the JAX package loads: input_ids and
attention_mask equal, on the M=12 model's own tokenizer files, the toy
vocab, a TCT-style dir and a RoBERTa BPE built here (ANCE), over the
synthetic corpus's texts, a fixed hard set and a hypothesis property; the
character tables against HF's; the fingerprints, a JAX-built TokenCache
opened by the port, and a port-written model dir read back by HF.

The character tables are HF `tokenizers`' own. To rebuild
repconc_tpu_torch/models/unicode_tables.py after a `tokenizers` upgrade:

    python tests/test_torch_tokenization.py --write-tables
"""
import json
import os
import pathlib
import random
import sys
import tarfile
import unicodedata

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
TABLES = ROOT / "repconc_tpu_torch" / "models" / "unicode_tables.py"
M12_TAR = ROOT / "artifacts" / "r5h_m12_conc_best.tar"
EXPORT_TAR = ROOT / "artifacts" / "r5h_export_hf.tar"
TOKENIZER_MEMBERS = ("vocab.txt", "tokenizer.json", "tokenizer_config.json",
                     "special_tokens_map.json")


# -- HF's character tables -------------------------------------------------

def _code_points():
    return [cp for cp in range(0x110000) if not 0xD800 <= cp <= 0xDFFF]


def _ranges(cps):
    out = []
    for cp in sorted(cps):
        if out and out[-1][1] == cp - 1:
            out[-1][1] = cp
        else:
            out.append([cp, cp])
    return tuple(tuple(r) for r in out)


class HFProbes:
    """Single-character questions put to HF `tokenizers`' components."""

    def __init__(self):
        from tokenizers import normalizers, pre_tokenizers

        self.clean = normalizers.BertNormalizer(
            clean_text=True, handle_chinese_chars=False, strip_accents=False,
            lowercase=False)
        self.strip = normalizers.BertNormalizer(
            clean_text=False, handle_chinese_chars=False, strip_accents=True,
            lowercase=False)
        self.lower = normalizers.BertNormalizer(
            clean_text=False, handle_chinese_chars=False, strip_accents=False,
            lowercase=True)
        self.nfd = normalizers.NFD()
        self.bert_pre = pre_tokenizers.BertPreTokenizer()
        self.byte_pre = pre_tokenizers.ByteLevel(add_prefix_space=False,
                                                 use_regex=True)

    def classes(self, cp: int) -> dict:
        c = chr(cp)
        bert = [p for p, _ in self.bert_pre.pre_tokenize_str("a" + c + "a")]
        letter = len(self.byte_pre.pre_tokenize_str("a" + c)) == 1
        ccc = unicodedata.combining(c)
        if ccc:
            # HF's combining class is Python's, or 0 where its tables predate
            # the character: a mark of class 0 is never reordered
            ref = "̴" if ccc != 1 else "́"  # classes 1 and 230
            still = (self.nfd.normalize_str("a" + c + ref) == "a" + c + ref
                     and self.nfd.normalize_str("a" + ref + c) == "a" + ref + c)
        return {
            "control": self.clean.normalize_str(c) == "",
            "whitespace": bert == ["a", "a"],
            "punctuation": len(bert) == 3,
            "mark_nonspacing": (unicodedata.normalize("NFD", c) == c
                                and self.strip.normalize_str(c) == ""),
            "letter": letter,
            "number": not letter and len(
                self.byte_pre.pre_tokenize_str("1" + c)) == 1,
            "ccc_zero": bool(ccc) and still,
            "lower": self.lower.normalize_str(c),
            "nfd": self.nfd.normalize_str(c),
        }


def hf_tables() -> dict:
    """Every table of unicode_tables.py, asked of HF for every code point."""
    probes = HFProbes()
    sets = {k: set() for k in ("control", "whitespace", "punctuation",
                               "mark_nonspacing", "letter", "number",
                               "ccc_zero")}
    lower, nfd = {}, {}
    for cp in _code_points():
        got = probes.classes(cp)
        for k in sets:
            if got[k]:
                sets[k].add(cp)
        if got["lower"] != chr(cp).lower():
            lower[cp] = got["lower"]
        if got["nfd"] != unicodedata.normalize("NFD", chr(cp)):
            nfd[cp] = got["nfd"]
    out = {k.upper(): _ranges(v) for k, v in sets.items()}
    out["LOWER"], out["NFD"] = lower, nfd
    return out


def write_tables(path=TABLES) -> None:
    import tokenizers

    t = hf_tables()

    def fmt_ranges(name, ranges):
        items = [f"(0x{a:X}, 0x{b:X})" for a, b in ranges]
        lines, line = [], "    "
        for item in items:
            if len(line) + len(item) + 2 > 79:
                lines.append(line.rstrip())
                line = "    "
            line += item + ", "
        lines.append(line.rstrip())
        return f"{name} = (\n" + "\n".join(lines) + "\n)\n"

    def fmt_map(name, mapping):
        body = "".join(f"    0x{cp:X}: {s.encode('unicode_escape').decode()!r},\n"
                       .replace("'\\\\", "'\\") for cp, s in sorted(mapping.items()))
        return f"{name} = {{\n{body}}}\n"

    text = (
        '"""Character tables of HF `tokenizers` (taken from version '
        f'{tokenizers.__version__}), for\nrepconc_tpu_torch/models/tokenization.py. '
        'Generated by\n`python tests/test_torch_tokenization.py --write-tables`; '
        'do not edit.\n\n'
        "Inclusive code point ranges: CONTROL, what BertNormalizer's clean_text\n"
        "drops; WHITESPACE, what splits words (Unicode White_Space); PUNCTUATION,\n"
        "what BertPreTokenizer isolates; MARK_NONSPACING, what strip_accents\n"
        "drops after NFD; LETTER and NUMBER, ByteLevel's \\\\p{L} and \\\\p{N};\n"
        "CCC_ZERO, marks that HF's NFD treats as starters (its tables predate\n"
        "them). LOWER and NFD: the characters whose lower case or decomposition\n"
        f"in HF differs from unicodedata {unicodedata.unidata_version}'s.\n"
        '"""\n\n'
        f"UNIDATA_VERSION = {unicodedata.unidata_version!r}\n\n")
    for name in ("CONTROL", "WHITESPACE", "PUNCTUATION", "MARK_NONSPACING",
                 "LETTER", "NUMBER", "CCC_ZERO"):
        text += fmt_ranges(name, t[name]) + "\n"
    text += fmt_map("LOWER", t["LOWER"]) + "\n" + fmt_map("NFD", t["NFD"])
    path.write_text(text)


# -- the tokenizer dirs ------------------------------------------------------

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
RICH_CHARS = ([chr(c) for c in range(33, 127)]
              + list("éèàüößçñåøæ中文字日本語한국어абвгдεζηθ²½ıσς"))
RICH_WORDS = ["the", "un", "##able", "##s", "##ing", "run", "##n", "cafe",
              "naive", "resume", "don", "stop", "title", "body", "q", "d"]


def _extract(tar_path, prefix, dest):
    if not tar_path.exists():
        pytest.skip(f"{tar_path.relative_to(ROOT)} is not in this checkout")
    dest.mkdir(parents=True, exist_ok=True)
    with tarfile.open(tar_path) as tar:
        for name in TOKENIZER_MEMBERS:
            (dest / name).write_bytes(tar.extractfile(f"{prefix}/{name}").read())
    return dest


def _bert_dir(root, vocab, vocab_only=False, cls_name="BertTokenizerFast"):
    import transformers

    root.mkdir(parents=True, exist_ok=True)
    (root / "vocab.txt").write_text("\n".join(vocab))
    getattr(transformers, cls_name)(vocab_file=str(root / "vocab.txt")
                                    ).save_pretrained(root)
    if vocab_only:  # the slow files only: vocab.txt with tokenizer_config.json
        (root / "tokenizer.json").unlink()
    return root


def _learn_merges(text, n):
    """n byte-level BPE merges learned on `text` (most frequent pair first,
    ties by the pair)."""
    from repconc_tpu_torch.models.tokenization import (_BYTE_LEVEL_WORDS,
                                                       bytes_to_unicode)

    b2u = bytes_to_unicode()
    words = {}
    for w in _BYTE_LEVEL_WORDS.findall(text):
        key = tuple(b2u[b] for b in w.encode("utf-8"))
        words[key] = words.get(key, 0) + 1
    merges = []
    for _ in range(n):
        pairs = {}
        for w, k in words.items():
            for p in zip(w, w[1:]):
                pairs[p] = pairs.get(p, 0) + k
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(best)
        merged = {}
        for w, k in words.items():
            out, j = [], 0
            while j < len(w):
                if j < len(w) - 1 and (w[j], w[j + 1]) == best:
                    out.append(w[j] + w[j + 1])
                    j += 2
                else:
                    out.append(w[j])
                    j += 1
            merged[tuple(out)] = merged.get(tuple(out), 0) + k
        words = merged
    return merges


def _bpe_dir(root, with_json=False):
    """A RoBERTa BPE: the 256 byte symbols, merges learned on English-like
    and mixed text, RoBERTa's special tokens; vocab.json with merges.txt,
    or the tokenizer.json HF saves from them."""
    from transformers import RobertaTokenizerFast

    from repconc_tpu_torch.models.tokenization import bytes_to_unicode

    root.mkdir(parents=True, exist_ok=True)
    text = ("the quick brown fox jumps over the lazy dog. it's a don't "
            "they'll we've title body café naïve résumé 中文字符 σας emoji 😀 "
            "numbers 123 4567 ²½ ") * 4
    merges = _learn_merges(text, 300)
    b2u = bytes_to_unicode()
    tokens = (["<s>", "<pad>", "</s>", "<unk>"] + [b2u[b] for b in range(256)]
              + [a + b for a, b in merges] + ["<mask>"])
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    (root / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False))
    (root / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    if with_json:
        RobertaTokenizerFast(vocab_file=str(root / "vocab.json"),
                             merges_file=str(root / "merges.txt")
                             ).save_pretrained(root)
        (root / "vocab.json").unlink()
        (root / "merges.txt").unlink()
    return root


# (dir maker, adapter) per case; the makers run once, lazily
CASES = {
    "m12": (lambda t: _extract(M12_TAR, "best", t / "m12"), None),
    "m12_export": (lambda t: _extract(EXPORT_TAR, "export_hf", t / "export"),
                   None),
    "toy": (lambda t: _bert_dir(t / "toy", SPECIALS + [f"w{i:02d}" for i in
                                                       range(40)]), None),
    "toy_vocab_txt": (lambda t: _bert_dir(
        t / "toy_txt", SPECIALS + [f"w{i:02d}" for i in range(40)],
        vocab_only=True), None),
    "distilbert": (lambda t: _bert_dir(
        t / "distil", SPECIALS + [f"w{i:02d}" for i in range(40)],
        cls_name="DistilBertTokenizerFast"), None),
    "wordpiece": (lambda t: _bert_dir(
        t / "rich", list(dict.fromkeys(SPECIALS + RICH_CHARS + [
            "##" + c for c in RICH_CHARS] + RICH_WORDS))), None),
    "tct": (lambda t: _bert_dir(
        t / "tct", list(dict.fromkeys(SPECIALS + RICH_CHARS + [
            "##" + c for c in RICH_CHARS] + RICH_WORDS))), "tct"),
    "ance": (lambda t: _bpe_dir(t / "ance"), "ance"),
    "roberta_json": (lambda t: _bpe_dir(t / "roberta", with_json=True), None),
}


@pytest.fixture(scope="module")
def tokenizers_of(tmp_path_factory):
    """case -> (dir, HF's tokenizer through the JAX package's loader, the
    port's tokenizer)."""
    from repconc_tpu.models import adapters as jax_adapters

    from repconc_tpu_torch.models import adapters

    root = tmp_path_factory.mktemp("tokenizers")
    made = {}

    def get(case):
        if case not in made:
            maker, adapter = CASES[case]
            d = str(maker(root))
            made[case] = (d, jax_adapters.load_adapter_tokenizer(d, adapter),
                          adapters.load_adapter_tokenizer(d, adapter))
        return made[case]
    return get


HARD = [
    "Café naïve RÉSUMÉ Ångström", "crème brûlée façade", "中文字符 mixed中文",
    "日本語のテキスト", "한국어 텍스트", "a\x00b\x07c​d﻿e\x7f",
    "ctrl\x1c\x1d\x1e\x1fsep", "soft\xadhyphen", "nbsp\xa0here thin",
    "title[SEP]body", "title [SEP] body", "x</s>y", "a [MASK] b[MASK]",
    "[CLS][SEP][PAD]", "[sep] lower", "w" * 101, "w" * 100, "", "   ",
    "\n\t\r", "x²½y ³ ¼", "emoji 😀👍🏽 🇯🇵", "runs   of    spaces\n\n\nnew",
    "İstanbul ΣΑΣ ǅ", "á̖ é̖̀", "don't stop it's",
    "ｆｕｌｌ　ｗｉｄｔｈ", "tabs\tand\ttabs", "a b c\x85d",
    "punct!?…—–\"'«»", "$5 + 3 = <8> ^_^ `x` |y| ~z~", "under_score",
    "sub0001a top001b noise0042 sub9999c", "the runs unable running",
    "\U000e0001tag\U000e0041", "private\U000f0000", "퟿￯",
    "͸unassigned\U0010fffd", "ᲉꟋ new case", "\U00011938",
]


def _corpus_texts(tmp_path_factory, sep):
    """The synthetic corpus's docs (make_pipeline_data synth, small), each
    title and body joined with the tokenizer's sep token as load_corpus
    does, and its queries."""
    from repconc_tpu_torch.recipes.make_pipeline_data import make_synth

    root = tmp_path_factory.getbasetemp() / "synth_texts"
    if not (root / "data" / "corpus.tsv").exists():
        make_synth(str(root), n_docs=120, n_train_queries=20, n_dev_queries=5,
                   n_topics=4, subtopics_per_topic=3, hidden_layers=1,
                   hidden_size=64)
    lines = (root / "data" / "corpus.tsv").read_text().splitlines()
    docs = [sep.join(f.strip() for f in ln.split("\t")[1:]) for ln in lines]
    queries = [ln.split("\t")[1] for ln in (
        root / "data" / "queries.train.tsv").read_text().splitlines()]
    return docs + queries


def _same(hf_tok, tok, texts, adapter, **kw):
    kinds = ("query", "doc") if adapter == "tct" else (None,)
    for kind in kinds:
        extra = {"input_text_type": kind} if kind else {}
        want = hf_tok(list(texts), **extra, **kw)
        got = tok(list(texts), **extra, **kw)
        assert got["input_ids"] == want["input_ids"], (kind, kw)
        assert got["attention_mask"] == want["attention_mask"], (kind, kw)


@pytest.mark.parametrize("inputs", ["corpus", "hard"])
@pytest.mark.parametrize("case", list(CASES))
def test_ids_equal_hf(tokenizers_of, tmp_path_factory, case, inputs):
    """input_ids and attention_mask equal HF's at padding=True and
    "max_length", truncation at 8 and 128."""
    _, hf_tok, tok = tokenizers_of(case)
    texts = (_corpus_texts(tmp_path_factory, hf_tok.sep_token)
             if inputs == "corpus" else HARD)
    for padding in (True, "max_length"):
        for max_length in (8, 128):
            _same(hf_tok, tok, texts, CASES[case][1], padding=padding,
                  truncation=True, max_length=max_length)


@pytest.mark.parametrize("case", ["m12", "wordpiece", "tct", "ance",
                                  "roberta_json"])
def test_ids_equal_hf_on_any_text(tokenizers_of, case):
    """The same on arbitrary unicode text (every code point but the
    surrogates), in batches of one to four."""
    _, hf_tok, tok = tokenizers_of(case)

    @settings(max_examples=150, deadline=None, derandomize=True,
              suppress_health_check=list(HealthCheck))
    @given(st.lists(st.text(max_size=80), min_size=1, max_size=4))
    def prop(texts):
        for max_length in (8, 128):
            _same(hf_tok, tok, texts, CASES[case][1], padding=True,
                  truncation=True, max_length=max_length)

    prop()


def test_tables_equal_hf():
    """The port's character tables answer as HF does at both ends of every
    range and at 4,000 seeded code points."""
    from repconc_tpu_torch.models import tokenization as T
    from repconc_tpu_torch.models import unicode_tables as tables

    probes = HFProbes()
    sets = {"control": tables.CONTROL, "whitespace": tables.WHITESPACE,
            "punctuation": tables.PUNCTUATION,
            "mark_nonspacing": tables.MARK_NONSPACING,
            "letter": tables.LETTER, "number": tables.NUMBER,
            "ccc_zero": tables.CCC_ZERO}
    points = set(random.Random(0).sample(_code_points(), 4000))
    for ranges in sets.values():
        for a, b in ranges:
            points.update((a - 1, a, b, b + 1))
    points = sorted(p for p in points
                    if 0 <= p < 0x110000 and not 0xD800 <= p <= 0xDFFF)
    members = {k: T._RangeSet(v) for k, v in sets.items()}
    for cp in points:
        got = probes.classes(cp)
        for k, m in members.items():
            assert (cp in m) == got[k], (k, hex(cp))
        assert T._lower(chr(cp)) == got["lower"], hex(cp)
        assert T._nfd(chr(cp)) == got["nfd"], hex(cp)


def test_normalizer_equals_hf_on_marks():
    """Runs of combining marks (canonical reordering, marks older and newer
    than HF's tables) normalize as HF's BertNormalizer does."""
    from tokenizers import normalizers

    from repconc_tpu_torch.models.tokenization import BertNormalizer

    marks = [cp for cp in _code_points() if unicodedata.combining(chr(cp))]
    rng = random.Random(1)
    for strip, lower in ((True, True), (True, False), (None, True)):
        hf = normalizers.BertNormalizer(clean_text=True,
                                        handle_chinese_chars=True,
                                        strip_accents=strip, lowercase=lower)
        port = BertNormalizer(True, True, strip, lower)
        for _ in range(2000):
            text = "".join(chr(rng.choice(marks + [0x61, 0xC9, 0x1E09, 0x4E2D]))
                           for _ in range(rng.randint(1, 7)))
            assert port(text) == hf.normalize_str(text), [hex(ord(c)) for c in text]


@pytest.mark.parametrize("case", ["m12", "toy", "toy_vocab_txt",
                                  "distilbert", "tct", "ance", "roberta_json"])
def test_fingerprint_equals_hf(tokenizers_of, case):
    """A TokenCache fingerprints the port's tokenizer as the JAX package
    fingerprints HF's: the HF class's name and the vocab in id order."""
    from repconc_tpu.eval import encode as jax_encode

    from repconc_tpu_torch.eval.encode import TokenCache

    _, hf_tok, tok = tokenizers_of(case)
    assert tok.hf_class_name == type(hf_tok).__name__
    assert tok.get_vocab() == hf_tok.get_vocab()
    assert tok.vocab_size == hf_tok.vocab_size
    assert tok.pad_token_id == hf_tok.pad_token_id
    assert tok.sep_token == hf_tok.sep_token
    assert (TokenCache.tokenizer_fingerprint(tok)
            == jax_encode.TokenCache.tokenizer_fingerprint(hf_tok))


def test_jax_token_cache_opens_in_the_port(tokenizers_of, tmp_path_factory,
                                           tmp_path):
    """A TokenCache the JAX package built with HF's tokenizer of the M=12
    model opens in the port with the port's tokenizer, and its batches
    equal the port's own tokenization."""
    from repconc_tpu.eval import encode as jax_encode

    from repconc_tpu_torch.eval.encode import TokenCache, tokenize_batch

    _, hf_tok, tok = tokenizers_of("m12")
    texts = _corpus_texts(tmp_path_factory, hf_tok.sep_token)
    jax_encode.TokenCache.build(texts, hf_tok, 32, str(tmp_path / "tc"),
                                chunk=37)
    cache = TokenCache.open(str(tmp_path / "tc"), texts, tok, 32)
    assert cache is not None
    for start in range(0, len(texts), 16):
        stop = min(start + 16, len(texts))
        ids, mask = cache.batch(start, stop - start, len(texts))
        want_ids, want_mask = tokenize_batch(tok, texts[start:stop], 32, "doc")
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(mask, want_mask)


@pytest.mark.parametrize("case", ["m12", "toy_vocab_txt", "tct", "ance",
                                  "roberta_json"])
def test_port_written_dir_reads_back_in_hf(tokenizers_of, tmp_path, case):
    """A model dir the port writes (repconc_model.save_pretrained, then the
    tokenizer's save_pretrained, as train/stage1.py::save_model_dir does)
    reads back in HF's AutoTokenizer, the JAX package's loader and the
    port's to the same ids."""
    from repconc_tpu.models import adapters as jax_adapters
    from transformers import AutoTokenizer

    from repconc_tpu_torch.models import adapters
    from repconc_tpu_torch.models.repconc_model import TOKENIZER_FILES

    _, hf_tok, tok = tokenizers_of(case)
    adapter = CASES[case][1]
    out = tmp_path / "saved"
    written = tok.save_pretrained(str(out))
    assert {os.path.basename(p) for p in written} <= set(TOKENIZER_FILES)
    texts = HARD[:20]
    again = adapters.load_adapter_tokenizer(str(out), adapter)
    jax_again = jax_adapters.load_adapter_tokenizer(str(out), adapter)
    _same(jax_again, again, texts, adapter, padding=True, truncation=True,
          max_length=64)
    _same(hf_tok, again, texts, adapter, padding=True, truncation=True,
          max_length=64)
    if adapter is None:
        plain = AutoTokenizer.from_pretrained(str(out))
        assert type(plain).__name__ == tok.hf_class_name
        _same(plain, again, texts, None, padding=True, truncation=True,
              max_length=64)


def test_memo_changes_no_id(tokenizers_of, tmp_path_factory):
    """The per-word memo, on, off and cleared at its limit, gives the same
    ids."""
    _, hf_tok, tok = tokenizers_of("wordpiece")
    texts = _corpus_texts(tmp_path_factory, "[SEP]") + HARD
    want = tok(texts, padding=True)["input_ids"]
    for limit in (0, 7):
        tok.memo_limit = limit
        tok._memo.clear()
        assert tok(texts, padding=True)["input_ids"] == want
        assert len(tok._memo) <= limit
    tok.memo_limit = 1 << 20


def test_call_convention(tokenizers_of):
    """HF's call forms the port uses: a single str, no padding, max_length
    alone truncates, padding="max_length" pads, add_special_tokens=False."""
    _, hf_tok, tok = tokenizers_of("wordpiece")
    for kw in ({}, {"max_length": 5}, {"padding": "max_length", "max_length": 12,
                                       "truncation": True},
               {"add_special_tokens": False}, {"padding": "longest"}):
        for text in ("the runs unable", ["the", "runs unable running"]):
            want = hf_tok(text, **kw)
            got = tok(text, **kw)
            assert got["input_ids"] == want["input_ids"], kw
            assert got["attention_mask"] == want["attention_mask"], kw
    ids = hf_tok("unable")["input_ids"]
    assert tok.convert_ids_to_tokens(ids) == hf_tok.convert_ids_to_tokens(ids)


@pytest.mark.parametrize("kind", ["Unigram", "WordLevel"])
def test_unsupported_tokenizer_json_raises(tmp_path, kind):
    """Another tokenizer.json model is refused with the families the port
    reads."""
    from repconc_tpu_torch.models.tokenization import load_tokenizer

    (tmp_path / "tokenizer.json").write_text(json.dumps(
        {"model": {"type": kind, "vocab": []}, "added_tokens": []}))
    with pytest.raises(ValueError, match="WordPiece.*byte-level BPE"):
        load_tokenizer(str(tmp_path))

if __name__ == "__main__":
    if sys.argv[1:] == ["--write-tables"]:
        write_tables()
        print(f"wrote {TABLES}")
    else:
        sys.exit(pytest.main([__file__, "-q"] + sys.argv[1:]))
