"""The system under test, built from a configuration file: the program's
(``rvdd_tpu_torch``) engine configuration and net.  Imported only inside a
run, so the harness's tests and its CPU-only parts need no program."""

from __future__ import annotations


def engine_config(cfg: dict, **kw):
    from rvdd_tpu_torch.recurrent.engine import EngineConfig

    e = cfg["engine"]
    return EngineConfig(model_patch_depth=e["model_patch_depth"],
                        future_patch_depth=e["future_patch_depth"],
                        feature_rec=e["feature_rec"], input_nc=e["input_nc"], **kw)


def resolve_preset(cfg: dict, preset: str) -> str:
    """The fused-path preset the program runs for ``preset`` ('auto'
    resolves as the program resolves it)."""
    e = cfg["engine"]
    if cfg["net"]["family"] == "convnext":
        from rvdd_tpu_torch.models.fast_convnext import cnx_precision

        cnx_precision(preset)
        return preset
    from rvdd_tpu_torch.models.fast_unet import resolve_fused_precision

    return resolve_fused_precision(preset, arch=cfg["arch"], feature_rec=e["feature_rec"],
                                   future=e["future_patch_depth"] > 0)


def build_net(cfg: dict, weights: dict, device):
    """The program's net for the configuration, holding ``weights``."""
    from rvdd_tpu_torch.models import build_network

    n = cfg["net"]
    net = build_network(cfg["arch"], n["in_channels"], n["out_channels"],
                        cfg["engine"]["feature_rec"], seed=0, device=device)
    net.load_state_dict(weights)
    return net
