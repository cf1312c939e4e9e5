"""Options (port of rvdd_tpu/config.py): one dataclass with rvdd_tpu's flag
names, defaults and values, so that one command line runs either package,
plus the port's ``--device`` (default ``cuda``; the tests pass ``cpu``).

The experiment name is generated as the reference does
("%s-%s%s-i%do%d%s"; reference: options/base_options.py:130-136), so
checkpoint directories line up.  :meth:`Options.engine_config` maps
rvdd_tpu's values onto the port's engine: ``--net_impl xla`` is the module
path and ``fused`` the CUDA chains; ``--warp_impl auto|xla|pallas|shift``
is ``auto|plain|kernel|plain`` (rvdd_tpu's ``shift`` is its banded TPU
training warp; the port's is the exact plain warp);
``--fused_precision auto`` resolves through the port's
``resolve_fused_precision``.  The train step's warp is
:meth:`Options.resolve_train_warp_impl`'s.  rvdd_tpu's ``--compilation_cache_dir`` is
parsed and ignored.  ``--mesh_shape``'s grammar is checked by
``parallel/mesh.py:make_mesh`` when training starts, not here; its
``space`` axis cuts each patch's rows over the processes of a data index
(parallel/space.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass

from rvdd_tpu_torch.recurrent.engine import EngineConfig

#: rvdd_tpu's --warp_impl values -> the port's EngineConfig.warp_impl
#: outside the train step
WARP_IMPLS = {"auto": "auto", "xla": "plain", "pallas": "kernel", "shift": "plain"}
#: rvdd_tpu's --net_impl values -> the port's EngineConfig.net_impl
NET_IMPLS = {"xla": "module", "fused": "fused"}


@dataclass
class Options:
    # basic
    checkpoints_dir: str = "./checkpoints"
    name: str = ""  # auto-generated if empty
    suffix: str = ""
    verbose: bool = False

    # model
    model: str = "recurrent"
    input_nc: int = 3
    output_nc: int = 3
    netDenoiser: str = "convunet-mode=fixedfeatures"
    init_type: str = "kaiming"
    init_gain: float = 0.02
    model_patch_depth: int = 2
    unroll_focus: str = "gradual04_from20"
    feature_rec: bool = False
    prev_noisy_frame: bool = False
    warp_raw: bool = False
    no_predemosaic: bool = False
    raw_gt: bool = False

    # dataset
    dataroot: str = "./datasets/train_dataset"
    nFolder: str = "noisy"
    gtFolder: str = "gt"
    gt_linear_RGB_Folder: str = "gt_linear_RGB"
    flowFolder: str = "flow"
    bit_depth: int = 12
    no_warp: bool = False
    warp_method: str = "tvl1"
    videos: str | None = None
    dataset_mode: str = "axel4rec"
    #: validation dataset registry name (reference: recurrent_model.py:27
    #: injects val_dataset_mode='infer4rec')
    val_dataset_mode: str = "infer4rec"
    batch_size: int = 2
    patch_width: int = 136
    patch_stride: int = 3
    patch_depth: int = 5
    future_patch_depth: int = 0
    frames2load: int = 10
    crop_data: str | None = None
    persist_flows: bool = True
    # compute TV-L1 on device inside the inference step instead of the
    # disk cache (self-contained streaming; the reference has no analogue)
    online_flow: bool = False
    # --online_flow solver preset: 'default' (the C library's parameters,
    # 5 warps / <=300 iters) or 'fast' (2 warps / <=75 iters — the
    # bench.py --fast_flow preset; PSNR delta measured in BENCH.md)
    flow_preset: str = "default"

    # training
    niter: int = 70
    niter_decay: int = 30
    beta1: float = 0.9
    lr: float = 0.00016
    lr_policy: str = "linear"
    lr_decay_iters: int = 50
    weight_decay: float = 0.01
    optimizer: str = "adamw"
    lambda_L1: float = 100.0
    print_freq: int = 100
    save_epoch_freq: int = 1
    autoresume: bool = False
    path2epoch: str = ""
    epoch: str = "latest_val"
    seed: int = 0
    # recompute each unrolling in the training backward
    # (torch.utils.checkpoint): the same gradients, activation memory of
    # one unrolling instead of all, about one more forward an unrolling
    remat: bool = False

    # validation
    val_epoch_freq: int = 1
    val_dataroot: str = "./datasets/validation_dataset"
    val_videos: str = "000,001,002,003,004"
    no_val: bool = False
    val_flow_from_denoised: bool = False
    # pad full frames up to a multiple (raw-domain pixels) so mixed frame
    # sizes share one jit specialization; 0 = exact sizes (default)
    val_pad_multiple: int = 0
    # stream whole clips through one lax.scan jit instead of per-frame
    # steps (no host sync per frame; first D frames use denoised-prev
    # recursion instead of the noisy-prev init, see scan_video)
    val_scan: bool = False

    # rvdd_tpu's accelerator flags
    #: 'data', 'data<N>' or 'data<N>xspace<M>' (parallel/mesh.py:make_mesh;
    #: N x M must equal the number of processes; M > 1 cuts each patch's
    #: rows over M of them)
    mesh_shape: str = "data"
    exact_precision: bool = True  # fp32 convs and matmuls, no TF32 (precision.py)
    #: training matmul precision: 'highest' (fp32-exact, 6-pass MXU — the
    #: default, strictest), 'high' (3-pass bf16 decomposition — the
    #: TF32-accumulation class the reference trains under on Ampere), or
    #: 'default' (1-pass bf16).  Applies to the train step (and in-loop
    #: validation); the validate CLI stays exact regardless.
    train_matmul_precision: str = "highest"
    #: residual radius of rvdd_tpu's banded training warp, for the clamp
    #: telemetry under --warp_impl shift (EngineConfig.shift_warp_radius)
    shift_warp_radius: int = 8
    #: the state warp: auto | xla (the plain PyTorch warp) | pallas (the
    #: CUDA warp kernel) | shift (the plain warp; in the train step it also
    #: logs what rvdd_tpu's banded sweep would clamp).  The train step
    #: always warps with the exact plain warp (resolve_train_warp_impl)
    warp_impl: str = "auto"
    #: 'xla' (the port's module path, fp32) | 'fused' (the CUDA chains;
    #: PERF.md has their speed by preset)
    net_impl: str = "xla"
    #: fused-path numerics: 'fast' (bf16, 1-pass MXU) | 'mixed' (fp32
    #: storage, manual 3-pass bf16_3x dots) | 'accurate' (fp32, 6-pass)
    fused_precision: str = "auto"  # auto -> parity-safe preset per variant
    #: rvdd_tpu's XLA compilation cache: the port compiles nothing for
    #: XLA, so the flag is parsed (shared command lines run) and ignored
    compilation_cache_dir: str = "~/.cache/rvdd_tpu/xla"
    #: fused-path recurrence-carry storage; bf16 carry rounding feeds back
    #: through the recurrence and accumulates over a clip (drift)
    state_dtype: str = "float32"
    #: a torch.profiler Chrome trace of steps 2..5 of the first epoch,
    #: <profile_dir>/rank<r>.json
    profile_dir: str = ""
    #: data parallelism from torchrun's environment: NCCL on the cards, gloo
    #: with --device cpu (parallel/mesh.py:init_distributed)
    distributed: bool = False
    #: where the port runs: 'cuda' (the card; raises without one) or 'cpu'
    device: str = "cuda"

    isTrain: bool = True

    def finalize(self) -> "Options":
        if not self.name:
            warpstr = "-warp" if not self.no_warp else ""
            sufstr = f"-{self.suffix}" if self.suffix else ""
            self.name = (
                f"{self.model}-{self.netDenoiser}{warpstr}"
                f"-i{self.input_nc}o{self.output_nc}{sufstr}"
            )
        return self

    @property
    def save_dir(self) -> str:
        return os.path.join(self.checkpoints_dir, self.name)

    def engine_config(self) -> EngineConfig:
        """The engine configuration of these options; ``--model`` resolves
        through the registry."""
        from rvdd_tpu_torch.registry import get_model

        if self.warp_impl not in WARP_IMPLS:
            raise ValueError(f"unknown --warp_impl {self.warp_impl!r}; have {sorted(WARP_IMPLS)}")
        if self.net_impl not in NET_IMPLS:
            raise ValueError(f"unknown --net_impl {self.net_impl!r}")
        return get_model(self.model)(
            model_patch_depth=self.model_patch_depth,
            patch_depth=self.patch_depth,
            future_patch_depth=self.future_patch_depth,
            input_nc=self.input_nc,
            output_nc=self.output_nc,
            no_warp=self.no_warp,
            no_predemosaic=self.no_predemosaic,
            warp_raw=self.warp_raw,
            prev_noisy_frame=self.prev_noisy_frame,
            feature_rec=self.feature_rec,
            raw_gt=self.raw_gt,
            lambda_l1=self.lambda_L1,
            warp_impl=WARP_IMPLS[self.warp_impl],
            net_impl=NET_IMPLS[self.net_impl],
            state_dtype=self.state_dtype,
            fused_precision=self.resolve_fused_precision(),
            shift_warp_radius=self.shift_warp_radius,
            remat=self.remat,
        )

    def resolve_train_warp_impl(self) -> str:
        """The train step's warp (rvdd_tpu/config.py:resolve_train_warp_impl):
        the exact plain warp whatever ``--warp_impl`` says, since the CUDA
        warp is forward-only and the plain warp's gather backward is a
        scatter-add on the card (rvdd_tpu trains on the TPU with its banded
        'shift' warp because XLA:TPU serializes that scatter).  ``shift``
        keeps its name, so the train step logs the clamp telemetry of
        rvdd_tpu's sweep."""
        if self.warp_impl not in WARP_IMPLS:
            raise ValueError(f"unknown --warp_impl {self.warp_impl!r}; have {sorted(WARP_IMPLS)}")
        return "shift" if self.warp_impl == "shift" else "plain"

    def resolve_fused_precision(self) -> str:
        from rvdd_tpu_torch.models.fast_unet import resolve_fused_precision

        if self.netDenoiser.startswith("newunet") and self.fused_precision != "auto":
            return self.fused_precision  # a ConvNeXt preset, checked by the engine
        return resolve_fused_precision(
            self.fused_precision,
            arch=self.netDenoiser,
            feature_rec=self.feature_rec,
            future=self.future_patch_depth > 0,
        )

    def gt_folder_for_mode(self) -> str:
        return self.gtFolder if self.raw_gt else self.gt_linear_RGB_Folder

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2, default=str)

    def dump(self) -> str:
        lines = ["----------------- Options ---------------"]
        for f_ in sorted(dataclasses.fields(self), key=lambda f: f.name):
            lines.append(f"{f_.name:>25}: {getattr(self, f_.name)}")
        lines.append("----------------- End -------------------")
        return "\n".join(lines)


def build_parser(train: bool = True) -> argparse.ArgumentParser:
    """argparse mirror of the dataclass (flags keep the reference names)."""
    p = argparse.ArgumentParser(formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    defaults = Options()
    if train:
        # reference train-mode default overrides (models/recurrent_model.py:27-28)
        defaults.patch_depth = 5
        defaults.patch_width = 136
    for f_ in dataclasses.fields(Options):
        if f_.name == "isTrain":
            continue
        default = getattr(defaults, f_.name)
        arg = f"--{f_.name}"
        if f_.type == "bool" or isinstance(default, bool):
            if default:
                p.add_argument(arg, action="store_true", default=True)
                p.add_argument(f"--no_{f_.name}".replace("no_no_", "no_"), dest=f_.name,
                               action="store_false")
            else:
                p.add_argument(arg, action="store_true", default=False)
        elif isinstance(default, int):
            p.add_argument(arg, type=int, default=default)
        elif isinstance(default, float):
            p.add_argument(arg, type=float, default=default)
        else:
            p.add_argument(arg, type=str, default=default)
    return p


def parse_options(argv=None, train: bool = True) -> Options:
    args = build_parser(train).parse_args(argv)
    opt = Options(**vars(args))
    opt.isTrain = train
    return opt.finalize()
