"""Training: optimizers and the train step, checkpoints, the epoch loop and
the validation loop (port of rvdd_tpu/training)."""
