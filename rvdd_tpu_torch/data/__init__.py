"""Data: image I/O without imageio, the flow cache, and the training and
inference datasets (port of rvdd_tpu/data)."""

from rvdd_tpu_torch.data.datasets import InferenceDataset, TrainWindowDataset
from rvdd_tpu_torch.data.flow_cache import FlowCache
from rvdd_tpu_torch.data.io import imread, imwrite, list_video_files, load_image

__all__ = ["FlowCache", "InferenceDataset", "TrainWindowDataset", "imread", "imwrite",
           "list_video_files", "load_image"]
