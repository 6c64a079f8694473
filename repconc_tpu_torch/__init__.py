"""repconc_tpu_torch — the PyTorch / CUDA port of repconc_tpu for NVIDIA Hopper.

It grows beside the JAX package, which stays the reference, one slice at a
time. This package imports torch, numpy and the standard library at module
level and nothing of repconc_tpu; `transformers` and `msgpack` are imported
lazily inside the few functions that need them.

Layer map (the same names as repconc_tpu, where a module exists yet):
  core/    config, checkpoint reading, device setup, phase stopwatch
  models/  the BERT-family dense encoder, the RepCONC head, weight import
  quant/   PQ codebook distances and argmin encode
  index/   flat top-k helpers, plain ADC search, the CUDA ADC scan (K1)
  eval/    batch encoding, TREC run IO, trec_eval-parity metrics, pipeline
  cli/     run_repconc_eval
  csrc/    hand-written CUDA kernels, built with nvcc at first use (build.py)
"""

__version__ = "0.1.0"
