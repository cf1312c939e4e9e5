"""Checkpoint loading and the validation loop (port of rvdd_tpu/training;
the training half waits for a later slice, ROADMAP.md)."""
