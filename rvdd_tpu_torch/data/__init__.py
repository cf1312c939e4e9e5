"""Data: image I/O without imageio, the flow cache, and the inference
dataset (port of rvdd_tpu/data)."""

from rvdd_tpu_torch.data.datasets import InferenceDataset
from rvdd_tpu_torch.data.flow_cache import FlowCache
from rvdd_tpu_torch.data.io import imread, imwrite, list_video_files, load_image

__all__ = ["FlowCache", "InferenceDataset", "imread", "imwrite", "list_video_files",
           "load_image"]
