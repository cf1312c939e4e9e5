"""The recurrence engine (recurrent/engine.py)."""

from rvdd_tpu_torch.recurrent.engine import (
    EngineConfig,
    RecurrentState,
    fused_pack,
    inference_step,
    init_state,
    prepare_frames,
    step,
)

__all__ = ["EngineConfig", "RecurrentState", "fused_pack", "inference_step",
           "init_state", "prepare_frames", "step"]
