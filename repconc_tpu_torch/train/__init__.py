"""Training (counterpart of repconc_tpu/train/): the data pipeline,
stage-1 RepCONC training and stage-2 JPQ training. Nothing is imported
here, so importing one module of the package loads only what that module
needs."""
