"""repconc_tpu_torch — the PyTorch / CUDA port of repconc_tpu for NVIDIA Hopper.

It grows beside the JAX package, which stays the reference, one slice at a
time. This package imports torch, numpy and the standard library at module
level and nothing of repconc_tpu; `transformers` is imported lazily inside
the few functions that need a real tokenizer.

Layer map (the same names as repconc_tpu, where a module exists yet):
  core/    config, model dirs (a numpy-only params.msgpack reader and
           writer), device setup, phase stopwatch, logging
  models/  the BERT-family dense encoder, the RepCONC head, flax-tree
           import and export
  quant/   PQ codebook distances, argmin and Sinkhorn-constrained encode,
           decode, the training losses
  index/   flat top-k helpers, ADC search (K1), k-means and IVF-PQ (K2, K3)
  eval/    batch encoding, TREC run IO, trec_eval-parity metrics, pipeline
  train/   the training data pipeline and stage-1 RepCONC training
  cli/     run_repconc_eval, run_train_conc
  csrc/    hand-written CUDA kernels, built with nvcc at first use (build.py)
"""

__version__ = "0.1.0"
