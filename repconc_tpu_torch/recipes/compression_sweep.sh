#!/bin/bash
# The TAS-Balanced compression sweep M=48/24/16/8 (64x-768x) on the
# PyTorch / CUDA port: the twin of recipes/compression_sweep.sh
# (BASELINE.json config 3; the reference's README.md:21 claims the range),
# through the port's run_pipeline.sh. Runs stages 5-10 per M after the
# shared stages 1-4 have completed once.
#
#   DEVICE=cuda bash repconc_tpu_torch/recipes/compression_sweep.sh
#
# FAMILY_ENV (default tas-balanced.env; a path, or the name of one of
# recipes/*.env, as run_pipeline.sh takes it) and SWEEP_M (default
# "48 24 16 8") point the sweep at another family or a subset of M, as
# the tests do on toy data; the family file must read M as
# M=${M:-...}. DEVICE (default cuda) reaches every CLI that takes a device.
set -eu
HERE=$(dirname "$0")
for M in ${SWEEP_M:-48 24 16 8}; do
  M=${M} bash "${HERE}/run_pipeline.sh" "${FAMILY_ENV:-tas-balanced.env}" 5 6 7 8 9 10
done
