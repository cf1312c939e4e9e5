"""Camera pipeline: sRGB <-> raw unprocessing, noise synthesis, scoring (port
of rvdd_tpu/ops/pipeline.py).

Inverse pipeline (sRGB video -> synthetic noisy GBRG raw) and forward
pipeline (linear RGB result -> sRGB for PSNR/SSIM scoring), with the
reference dataset tooling's numerics (reference:
dataset/generate_raw_from_RGB.py, dataset/fwd_ppipe.py).  Everything is
float32 PyTorch on the tensors' device, so raw synthesis runs on the card;
the colour matrices are applied as weighted sums, not matmuls, so no TF32
product enters.  Random draws come from a ``torch.Generator`` where
rvdd_tpu takes a ``jax.random`` key: the dither first, then the noise.

Value domains:
* sRGB in [0, 255] at the pipeline boundary (like the PNG files),
* linear camera RGB / packed raw in [0, 1] internally,
* stored raw in the 12-bit CRVD-matched range (black level 240).
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

# Color correction matrix (from the CRVD authors; reference:
# dataset/generate_raw_from_RGB.py:101) and its inverse used for scoring
# (reference: dataset/fwd_ppipe.py:14).
RGB2CAM = np.array(
    [
        [0.95640505, 0.17353177, -0.13219438],
        [0.14135948, 0.80402001, 0.07771696],
        [0.05432832, 0.29852577, 0.67210576],
    ],
    np.float32,
)
CAM2RGB = np.array(
    [
        [1.07955733, -0.40125771, 0.32170038],
        [-0.15390743, 1.35677921, -0.20287178],
        [-0.00235972, -0.55155296, 1.55391268],
    ],
    np.float32,
)

# Per-sequence white balance (rgb_gain_n, red_gain, blue_gain) of the 30 REDS
# validation sequences; index [seq][0] = ISO 12800, [seq][1] = ISO 3200
# (reference: dataset/fwd_ppipe.py:11-12).  These are calibration data the
# released checkpoints depend on.
WHITE_BALANCE_VAL = [
    [[0.7092, 1.9675, 3.6828], [0.8236, 2.2221, 3.3301]],
    [[0.7401, 2.1030, 3.6304], [0.7644, 1.9503, 3.5006]],
    [[0.9161, 2.2784, 3.6755], [0.7601, 2.0998, 3.3854]],
    [[0.9525, 2.3370, 3.6792], [0.7360, 2.3697, 3.4119]],
    [[0.9605, 2.3947, 3.4367], [0.7404, 2.3139, 3.5170]],
    [[0.7609, 2.2813, 3.4110], [0.8902, 2.3187, 3.4019]],
    [[0.7750, 2.2654, 3.5609], [0.7345, 2.0626, 3.5793]],
    [[0.8840, 1.9958, 3.6247], [0.8833, 2.0230, 3.3515]],
    [[0.6943, 2.2786, 3.3560], [0.9260, 2.3253, 3.5130]],
    [[0.9010, 2.2090, 3.6154], [0.6274, 1.9355, 3.3173]],
    [[0.7958, 1.9339, 3.4810], [0.9572, 2.2042, 3.6575]],
    [[0.8399, 2.0257, 3.6682], [0.9359, 2.2613, 3.6852]],
    [[0.7440, 2.1734, 3.4105], [0.7275, 2.3677, 3.6735]],
    [[0.5619, 1.9805, 3.4812], [0.8135, 1.9108, 3.6120]],
    [[0.8667, 2.0147, 3.6875], [0.8300, 1.9923, 3.6988]],
    [[0.7737, 2.2526, 3.5053], [0.9132, 2.3117, 3.4007]],
    [[0.7509, 2.0487, 3.3553], [0.6704, 1.9102, 3.6929]],
    [[0.7212, 2.0658, 3.5201], [0.6869, 2.1378, 3.5632]],
    [[0.7151, 2.0195, 3.5290], [0.6519, 2.1796, 3.4783]],
    [[0.8090, 2.3589, 3.5027], [0.6393, 1.9052, 3.6153]],
    [[0.7448, 1.9092, 3.4494], [0.5803, 2.3618, 3.5934]],
    [[0.7697, 1.9471, 3.6772], [0.7726, 2.1623, 3.6192]],
    [[0.6977, 2.1741, 3.3000], [0.8566, 2.0728, 3.6538]],
    [[0.7005, 2.2215, 3.3929], [0.7252, 2.3532, 3.6297]],
    [[0.8323, 1.9109, 3.6082], [0.9037, 2.3036, 3.6862]],
    [[0.9798, 2.2035, 3.4980], [0.8641, 1.9713, 3.4595]],
    [[0.7984, 2.3540, 3.3481], [0.7381, 2.0972, 3.6256]],
    [[0.8305, 2.0535, 3.3063], [0.8017, 2.0211, 3.5449]],
    [[0.7706, 2.3751, 3.5043], [0.6495, 2.1595, 3.5811]],
    [[0.7892, 1.9688, 3.3180], [0.8423, 2.0606, 3.5152]],
]

# Heteroscedastic Gaussian read+shot noise model per ISO:
# sigma^2 = a * x + b  (reference: dataset/generate_raw_from_RGB.py:186-189).
NOISE_PARAMS = {3200: (8.0034, -2043.51144), 12800: (28.3015, -6307.62081)}

# CRVD percentile-matching affine per ISO (1st/99th percentiles of a first
# REDS generation were 245/2305; reference: generate_raw_from_RGB.py:173-179)
PERCENTILE_AFFINE = {3200: (266.0, 3610.0), 12800: (268.0, 4075.0)}

BLACK_LEVEL = 240.0
WHITE_LEVEL = 4095.0


class Gains(NamedTuple):
    """White balance: overall brightening 1/n and the red and blue gains
    (float32 values)."""

    rgb_gain: float
    red_gain: float
    blue_gain: float


def _gains(n: float, red: float, blue: float) -> Gains:
    return Gains(float(np.float32(1.0 / n)), float(np.float32(red)), float(np.float32(blue)))


def find_gains(seq: int, iso: int) -> Gains:
    """Validation-table lookup (reference: fwd_ppipe.py:43-46)."""
    n, red, blue = WHITE_BALANCE_VAL[seq][1 if iso == 3200 else 0]
    return _gains(n, red, blue)


def load_wb_table(split: str = "train", iso: int = 3200) -> np.ndarray:
    """Per-sequence calibration gains [(n, red, blue)] of the reference's
    coefficient files (reference:
    dataset/white_balance_coeffs_{train,val}_iso*.txt), from the package's
    resources/white_balance.json."""
    path = Path(__file__).resolve().parent.parent / "resources" / "white_balance.json"
    with open(path) as f:
        tables = json.load(f)
    return np.asarray(tables[f"{split}_{iso}"], np.float32)


def gains_from_table(table: np.ndarray, seq: int) -> Gains:
    n, red, blue = (float(v) for v in table[seq])
    return _gains(n, red, blue)


def parse_wb_table(path: str) -> np.ndarray:
    """Parse a 'white_balance_coeffs_*.txt' table -> [N, 3] of (n, red, blue).

    The files carry lines like
    ``Seq = 000, n = tensor([0.8163]), red_gain = ... , blue_gain = ...``.
    """
    rows = []
    pat = re.compile(r"tensor\(\[([-0-9.eE]+)\]\)")
    with open(path) as f:
        for line in f:
            vals = pat.findall(line)
            if len(vals) == 3:
                rows.append([float(v) for v in vals])
    return np.asarray(rows, np.float32)


def _scalars(like: torch.Tensor, *vals) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# inverse pipeline: sRGB -> linear camera RGB -> packed raw
# ---------------------------------------------------------------------------


def inverse_smoothstep(x: torch.Tensor) -> torch.Tensor:
    """Invert the global tone curve 3x^2-2x^3 (generate_raw_from_RGB.py:45-51)."""
    x = x.clamp(0.0, 1.0)
    return 0.5 - torch.sin(torch.asin(1.0 - 2.0 * x) / 3.0)


def smoothstep(x: torch.Tensor) -> torch.Tensor:
    """Global tone curve (fwd_ppipe.py:72)."""
    return 3.0 * x**2 - 2.0 * x**3


def gamma_expansion(x: torch.Tensor) -> torch.Tensor:
    return x.clamp(min=1e-8) ** 2.2


def apply_ccm(img: torch.Tensor, ccm: np.ndarray) -> torch.Tensor:
    """[..., 3] times ccm^T, as a weighted sum of the channels."""
    m = torch.as_tensor(np.asarray(ccm, np.float32), device=img.device)
    return (img[..., None, :] * m).sum(-1)


def safe_invert_gains(img: torch.Tensor, gains: Gains) -> torch.Tensor:
    """Divide out white balance and brightening (generate_raw_from_RGB.py:74-83)."""
    rgb, red, blue = _scalars(img, gains.rgb_gain, gains.red_gain, gains.blue_gain)
    g = torch.stack([1.0 / red, torch.ones_like(red), 1.0 / blue]) / rgb
    return img * g


def mosaic_gbrg(img: torch.Tensor) -> torch.Tensor:
    """Full-res [..., 2H, 2W, 3] linear RGB -> packed GBRG raw [..., H, W, 4]
    (generate_raw_from_RGB.py:86-96)."""
    g = img[..., 0::2, 0::2, 1]
    b = img[..., 0::2, 1::2, 2]
    r = img[..., 1::2, 0::2, 0]
    g2 = img[..., 1::2, 1::2, 1]
    return torch.stack([g, b, r, g2], dim=-1)


def unprocess(srgb_255, gains: Gains, generator: Optional[torch.Generator] = None):
    """sRGB [.., 2H, 2W, 3] in [0,255] -> (linear RGB [0,1], packed raw [0,1]).

    Matches single_image_rgb2raw (generate_raw_from_RGB.py:99-127): adds
    U(-0.5, 0.5) dequantization dither (when a generator is given), darkens
    by /266, inverts tone map, gamma, CCM and white balance.
    """
    x = torch.as_tensor(srgb_255).float()
    if generator is not None:
        x = x + (torch.rand(x.shape, generator=generator, device=x.device) - 0.5)
    x = x / 266.0  # the reference darkens by /266 instead of /255
    x = inverse_smoothstep(x)
    x = gamma_expansion(x)
    x = apply_ccm(x, RGB2CAM)
    x = safe_invert_gains(x, gains)
    x = x.clamp(0.0, 1.0)
    return x, mosaic_gbrg(x)


def to_stored_range(x01: torch.Tensor, iso: int) -> torch.Tensor:
    """[0,1] -> 12-bit CRVD-matched range (generate_raw_from_RGB.py:170-179)."""
    lo, hi = PERCENTILE_AFFINE[iso]
    x = x01 * (WHITE_LEVEL - BLACK_LEVEL) + BLACK_LEVEL
    return (hi - lo) * (x - 245.0) / (2305.0 - 245.0) + lo


def add_noise(raw: torch.Tensor, iso: int, generator: torch.Generator) -> torch.Tensor:
    """Heteroscedastic Gaussian noise in the stored range
    (generate_raw_from_RGB.py:186-189)."""
    a, b = NOISE_PARAMS[iso]
    sigma = torch.sqrt((a * raw + b).clamp(min=0.0))
    return raw + sigma * torch.randn(raw.shape, generator=generator, device=raw.device)


def synthesize_raw(srgb_255, gains: Gains, iso: int, generator: torch.Generator):
    """Raw synthesis of one frame: sRGB -> (gt_raw, gt_linear_rgb,
    noisy_raw), all in the stored 12-bit range; the dither and then the
    noise are drawn from ``generator`` (on the frame's device)."""
    linear_rgb, raw = unprocess(srgb_255, gains, generator)
    gt_linear = to_stored_range(linear_rgb, iso)
    gt_raw = to_stored_range(raw, iso)
    noisy = add_noise(gt_raw, iso, generator)
    return gt_raw, gt_linear, noisy


# ---------------------------------------------------------------------------
# forward pipeline: linear RGB -> sRGB (scoring)
# ---------------------------------------------------------------------------


def apply_gains(img: torch.Tensor, gains: Gains) -> torch.Tensor:
    """fwd_ppipe.py:28-40: divide by [1/(red*rgb), 1/rgb, 1/(blue*rgb)]."""
    rgb, red, blue = _scalars(img, gains.rgb_gain, gains.red_gain, gains.blue_gain)
    g = torch.stack([1.0 / (red * rgb), 1.0 / rgb, 1.0 / (blue * rgb)])
    return img / g


def forward_pipeline(im_stored, gains: Gains, iso: int) -> torch.Tensor:
    """Stored-range linear RGB [..., 3] -> sRGB in [0, 255] (float32).

    Matches ppipe (fwd_ppipe.py:48-77) including its in-place gamma quirk:
    values <= 1e-8 pass through ungamma'd.
    """
    lo, hi = PERCENTILE_AFFINE[iso]
    im = torch.as_tensor(im_stored).float()
    im = (im - lo) * (2305.0 - 245.0) / (hi - lo) + 245.0
    im = (im - BLACK_LEVEL) / (WHITE_LEVEL - BLACK_LEVEL)
    im = apply_gains(im, gains)
    im = apply_ccm(im, CAM2RGB)
    im = torch.where(im > 1e-8, im.abs() ** (1.0 / 2.2), im)
    im = smoothstep(im)
    return im * 255.0
