"""The benchmark's plain reference: fp32 PyTorch of the nets, the frame
operations, the recurrent step, the training loss and AdamW.  It imports
nothing of the program (``rvdd_tpu_torch``) and takes nothing the program
made: the harness hands both sides the same weights and inputs."""

import contextlib

import torch


@contextlib.contextmanager
def tf32(on: bool):
    """cuBLAS's and cuDNN's TF32 on or off for the scope; the reference runs
    with it off (float32 as stated), the control of a float32
    configuration with it on."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
