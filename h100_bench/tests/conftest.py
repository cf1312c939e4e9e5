"""Fixtures of the harness's tests.  Card tests are marked ``gpu`` and
decide in the ``card`` fixture, not at import, whether there is a card."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: a stream mix small enough for the CPU (the plain versions of the kernels)
TINY_STREAM = dict(raw_height=32, raw_width=64, windows=4, warmup_frames=4, start_frames=3,
                   pairs=[[0, 3], [3, 6]], trace_frames=8)
#: a train mix small enough for the CPU
TINY_TRAIN = dict(patch_height=16, patch_width=16, pool=4, trace_steps=2)


def tiny(cell: str) -> dict:
    return TINY_STREAM if cell.endswith("stream") else TINY_TRAIN


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 4))
    yield
    torch.set_num_threads(saved)
