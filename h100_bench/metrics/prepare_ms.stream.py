"""Device ms a frame in the kernels launched under the harness's span
around ``prepare_frames`` (demosaic, flow upsample)."""


def read(t):
    kernels = t.under("h100b.prepare")
    if not kernels:
        return None
    return 1e3 * sum(e - s for _, s, e in kernels) / t.units
