"""Tokenizer loading behind the adapter protocol (counterpart of
repconc_tpu/models/adapters.py:17-75). An adapter supplies only its
tokenizer: its encoder variant is EncoderConfig data (models/auto.py).

* ANCE lower-cases all text before tokenization (modeling_ance.py:46-54).
* TCT-ColBERT: '[CLS] [Q] ' + query padded with [MASK] to length 36 /
  '[CLS] [D] ' + doc, add_special_tokens=False (modeling_tct.py:49-58).

Every tokenizer is the port's own (models/tokenization.py), on every
device: the same ids as the HF class each one stands for, without
`transformers`. Register new adapters with @register_adapter("name").
"""
from __future__ import annotations

from typing import Callable, Dict

from repconc_tpu_torch.models.tokenization import (ByteLevelBPETokenizer,
                                                   WordPieceTokenizer,
                                                   load_tokenizer)

_TOKENIZER_REGISTRY: Dict[str, Callable] = {}


def register_adapter(name: str):
    def deco(fn):
        _TOKENIZER_REGISTRY[name] = fn
        return fn
    return deco


def load_adapter_tokenizer(model_dir: str, adapter: str = None):
    """The tokenizer saved in `model_dir`, wrapped by the adapter protocol."""
    if adapter in _TOKENIZER_REGISTRY:
        return _TOKENIZER_REGISTRY[adapter](model_dir)
    return load_tokenizer(model_dir)


class ANCETokenizer(ByteLevelBPETokenizer):
    """ANCE lower-cases text before tokenization; takes lists only."""

    ADAPTER_CLASS = "ANCETokenizerFast"

    def __call__(self, text, *args, **kwargs):
        if not isinstance(text, (list, tuple)):
            raise TypeError("the ANCE tokenizer takes a list of strings, "
                            f"got {type(text).__name__}")
        return super().__call__([t.lower() for t in text], *args, **kwargs)


class TCTTokenizer(WordPieceTokenizer):
    """TCT query / doc markers and the fixed-36 query expansion; takes the
    input_text_type protocol."""

    ADAPTER_CLASS = "TCTTokenizerFast"

    def __call__(self, text, input_text_type, max_length=None,
                 add_special_tokens=False, **kwargs):
        if input_text_type == "query":
            max_length = 36
            text = ["[CLS] [Q] " + q + "[MASK]" * 36 for q in text]
        elif input_text_type == "doc":
            text = ["[CLS] [D] " + d for d in text]
        else:
            raise NotImplementedError(input_text_type)
        return super().__call__(text, max_length=max_length,
                                add_special_tokens=False, **kwargs)


@register_adapter("ance")
def _ance_tokenizer(model_dir: str):
    return ANCETokenizer.from_pretrained(model_dir)


@register_adapter("tct")
def _tct_tokenizer(model_dir: str):
    return TCTTokenizer.from_pretrained(model_dir)
