"""The recurrence engine (recurrent/engine.py)."""

from rvdd_tpu_torch.recurrent.engine import (
    EngineConfig,
    RecurrentState,
    compute_losses,
    fused_pack,
    inference_step,
    init_state,
    prepare_frames,
    scan_video,
    step,
    unrolled_forward,
)

__all__ = ["EngineConfig", "RecurrentState", "compute_losses", "fused_pack",
           "inference_step", "init_state", "prepare_frames", "scan_video", "step",
           "unrolled_forward"]
