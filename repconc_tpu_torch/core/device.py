"""Device selection for the port's entry points.

Entry points take an explicit `device` that defaults to "cuda"; they run on
the CPU only when the caller asks. A CUDA request without a card raises: no
entry point carries on on the CPU by itself.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`, with fp32 ranking math kept at full fp32.

    TF32 is switched off for matmuls and for cuDNN: the JAX package forces
    Precision.HIGHEST where rankings are decided (quant/codebook.py:44-51,
    index/adc.py:24,32-33, models/repconc_model.py:76-77) because reduced
    precision flips argmins and near-tie rankings. TF32 keeps ~10 mantissa
    bits, as bf16 keeps 8, and flips them the same way. bf16 GEMMs (a
    bfloat16 encoder, models/transformer.py) accumulate in fp32 as XLA's
    do: cuBLAS's reduced-precision reductions are switched off too.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
        if dev.index is None:  # "cuda" -> "cuda:<current>", as tensors report it
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
