"""Tokenizer loading behind the adapter protocol (counterpart of
repconc_tpu/models/adapters.py:31-40). `transformers` is imported inside
the loader only: nothing else in the port needs it."""
from __future__ import annotations

# adapters of repconc_tpu/models/adapters.py:41-75 not ported yet
_PENDING_ADAPTERS = ("ance", "tct")


def load_adapter_tokenizer(model_dir: str, adapter: str = None):
    """The HF tokenizer saved in `model_dir`."""
    if adapter in _PENDING_ADAPTERS:
        raise NotImplementedError(
            f"the {adapter!r} tokenizer adapter is not ported yet "
            "(ROADMAP.md, Queue 1 item 3)")
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(model_dir)
