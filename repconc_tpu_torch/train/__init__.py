"""Training (counterpart of repconc_tpu/train/): the data pipeline and
stage-1 RepCONC training. Nothing is imported here, so importing one
module of the package loads only what that module needs."""
