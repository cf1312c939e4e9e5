"""Plain PyTorch ops (NHWC) and the CUDA kernel wrappers under ``ops.cuda``."""
