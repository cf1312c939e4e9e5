"""Training CLI (port of rvdd_tpu/cli/train.py; reference: train.py).
Takes rvdd_tpu's flags plus ``--device`` (default ``cuda``; the card, which
it needs unless ``--device cpu`` is given).

    python -m rvdd_tpu_torch.cli.train --netDenoiser convunet-mode=fixedfeatures+feat \\
        --feature_rec --dataroot data/train --val_dataroot data/validation \\
        --gtFolder gt_iso3200 --nFolder noisy_iso3200 \\
        --gt_linear_RGB_Folder gt_raw_linear_RGB_iso3200 [--autoresume]
"""

from __future__ import annotations

from rvdd_tpu_torch.config import parse_options
from rvdd_tpu_torch.training.loop import train


def main(argv=None) -> dict:
    """Returns what :func:`rvdd_tpu_torch.training.loop.train` measured."""
    return train(parse_options(argv, train=True))


if __name__ == "__main__":
    main()
