"""Wrappers of the hand-written CUDA kernels in ``rvdd_tpu_torch/csrc``.

Each wrapper runs its kernel on CUDA tensors, counts the launch in its
``launches`` attribute, and runs the plain PyTorch version beside it in the
same module only when it is given CPU tensors.  No wrapper falls back from
a CUDA tensor to the plain version.
"""
