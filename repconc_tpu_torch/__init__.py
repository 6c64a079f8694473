"""repconc_tpu_torch — the PyTorch / CUDA port of repconc_tpu for NVIDIA Hopper.

It grows beside the JAX package, which stays the reference, one slice at a
time. This package imports torch, numpy and the standard library at module
level and nothing of repconc_tpu; `transformers` is imported lazily inside
the few functions that need a real tokenizer.

Layer map (the same names as repconc_tpu, where a module exists yet):
  core/    config, model dirs (numpy-only readers and writers of
           params.msgpack and safetensors), device setup, process groups
           and the data-parallel mesh, profiler traces and the phase
           stopwatch, logging
  models/  the BERT-family dense encoder (fp32 or bf16 activations), the
           RepCONC head, flax-tree import and export, HF checkpoints, the
           adapter tokenizers
  quant/   PQ codebook distances, argmin and Sinkhorn-constrained encode,
           decode, the training losses
  index/   dense flat search, ADC search (K1), k-means (plain and
           balanced), PQ, OPQ and IVF-PQ (K2, K3; decoded residency)
  eval/    batch encoding (shard-resumable for a corpus), TREC run IO,
           trec_eval-parity metrics, pipeline
  train/   the training data pipeline, the OPQ warm-up, stage-1 RepCONC
           (and stage-0 dense) training and stage-2 JPQ training (K1's two
           passes in every step), on one device or data-parallel
  cli/     every stage of the pipeline but the dataset download:
           run_train_dense, run_customize_dense, run_dense_eval,
           run_gen_valid_set, run_warmup, run_extract_hardneg,
           run_train_conc, run_repconc_eval, run_train_jpq, and
           run_ivf_sweep
  parallel/ corpus-sharded search and data-parallel encoding across ranks
  recipes/ bench_stage1_scale, the production stage-1 step on the card
  csrc/    hand-written CUDA kernels, built with nvcc at first use (build.py)
"""

__version__ = "0.1.0"
