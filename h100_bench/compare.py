"""The numbers the correctness checks compare, program against reference."""

from __future__ import annotations

from typing import Dict, Iterable, List

import torch


def frame_errors(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    """A frame's errors against the reference's, each relative to the
    reference: the largest (``max_err``), the mean (``mean_err``) and the
    root mean square (``rms_err``) of |prog - ref|.  A frame that is not
    finite reads inf."""
    p, r = prog.double(), ref.double()
    d = (p - r).abs()
    if not torch.isfinite(p).all():
        return {"max_err": float("inf"), "mean_err": float("inf"), "rms_err": float("inf")}
    return {"max_err": float(d.max() / r.abs().max()),
            "mean_err": float(d.mean() / r.abs().mean()),
            "rms_err": float(d.square().mean().sqrt() / r.square().mean().sqrt())}


def worst(readings: Iterable[Dict[str, float]], prefix: str = "") -> Dict[str, float]:
    """The largest of each reading over several frames."""
    out: Dict[str, float] = {}
    for rd in readings:
        for k, v in rd.items():
            out[prefix + k] = max(out.get(prefix + k, 0.0), v)
    return out


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             names: List[str], median: bool = False) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    relative to the reference's norm of that leaf or of the median leaf,
    whichever is larger (``median``: the median leaf's gap); inf where the
    program lacks a leaf or reads NaN."""
    if not names or any(k not in prog for k in names):
        return float("inf")
    rn = {k: float(ref[k].double().norm()) for k in names}
    mid = sorted(rn.values())[len(rn) // 2]
    gaps = []
    for k in names:
        pn = float(prog[k].double().norm())
        if pn != pn:
            return float("inf")
        gaps.append(abs(pn - rn[k]) / max(rn[k], mid))
    return sorted(gaps)[len(gaps) // 2] if median else max(gaps)


def moved_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others (nought to rounding, as a bias under a
    normalization) move under Adam by round-off alone."""
    norms = {k: float(g.double().norm()) for k, g in ref_grads.items()}
    median = sorted(norms.values())[len(norms) // 2]
    return sorted(k for k, v in norms.items() if v >= 1e-3 * median)
