"""Name registries for datasets and models (port of rvdd_tpu/registry.py):
the CLI names ``--model recurrent``, ``--dataset_mode axel4rec`` and
``--val_dataset_mode infer4rec`` resolve here, and user code can
``register_*`` its own."""

from __future__ import annotations

from typing import Callable, Dict

_DATASETS: Dict[str, Callable] = {}
_MODELS: Dict[str, Callable] = {}


def register_dataset(name: str, factory: Callable) -> None:
    _DATASETS[name] = factory


def register_model(name: str, factory: Callable) -> None:
    _MODELS[name] = factory


def get_dataset(name: str) -> Callable:
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset_mode '{name}'; have {sorted(_DATASETS)}")
    return _DATASETS[name]


def get_model(name: str) -> Callable:
    if name not in _MODELS:
        raise KeyError(f"unknown model '{name}'; have {sorted(_MODELS)}")
    return _MODELS[name]


def _register_builtins() -> None:
    from rvdd_tpu_torch.data.datasets import InferenceDataset, TrainWindowDataset
    from rvdd_tpu_torch.recurrent.engine import EngineConfig

    register_dataset("axel4rec", TrainWindowDataset)
    register_dataset("infer4rec", InferenceDataset)
    register_model("recurrent", EngineConfig)


_register_builtins()
