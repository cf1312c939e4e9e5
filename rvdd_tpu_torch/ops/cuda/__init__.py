"""Wrappers of the hand-written CUDA kernels in ``rvdd_tpu_torch/csrc``.

Each wrapper runs its kernel on CUDA tensors, counts the launch in its
``launches`` attribute, and runs the plain PyTorch version beside it in the
same module only when it is given CPU tensors.  No wrapper falls back from
a CUDA tensor to the plain version.  The demosaic is the exception to where
the plain version lives: ``ops/demosaic.py`` holds it and the dispatch, and
``demosaic.hamilton_adams_cuda`` takes CUDA float32 raw only; the plain
version runs on the card only for raw that requires grad.
"""
