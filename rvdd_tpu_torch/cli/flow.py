"""Standalone optical-flow CLI (port of rvdd_tpu/cli/flow.py; the IPOL
tvl1flow demo, reference: 3rdparty/tvl1flow/main.c) running the port's
TV-L1 solver on the card (``--device cpu`` on the CPU).

    python -m rvdd_tpu_torch.cli.flow I0.png I1.png out.tif
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from rvdd_tpu_torch.data.io import imread, imwrite
from rvdd_tpu_torch.device import resolve_device
from rvdd_tpu_torch.ops.tvl1 import TVL1Params, to_gray, tvl1_flow


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("i0")
    p.add_argument("i1")
    p.add_argument("out", nargs="?", default="flow.tif")
    p.add_argument("--tau", type=float, default=0.25)
    p.add_argument("--lambda_", type=float, default=0.15)
    p.add_argument("--theta", type=float, default=0.3)
    p.add_argument("--nscales", type=int, default=100)
    p.add_argument("--zfactor", type=float, default=0.5)
    p.add_argument("--nwarps", type=int, default=5)
    p.add_argument("--epsilon", type=float, default=0.01)
    p.add_argument("--device", type=str, default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)

    params = TVL1Params(tau=a.tau, lambda_=a.lambda_, theta=a.theta, nscales=a.nscales,
                        zfactor=a.zfactor, nwarps=a.nwarps, epsilon=a.epsilon)

    def gray(path):
        return to_gray(torch.from_numpy(imread(path).astype(np.float32)).to(dev))

    flow = tvl1_flow(gray(a.i0), gray(a.i1), params).cpu().numpy()
    imwrite(a.out, flow.astype(np.float32))
    print(f"wrote {a.out}: mean |u|={np.abs(flow[..., 0]).mean():.3f} "
          f"|v|={np.abs(flow[..., 1]).mean():.3f}")
    return flow


if __name__ == "__main__":
    main()
