"""Device choice and fp32 precision for the port's entry points."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the CUDA card.

    There is no quiet move to the CPU: without a card, a caller who wants
    the CPU says so (``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' "
                               "to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def exact_fp32():
    """cuDNN convolutions in full fp32 inside the block (TF32 off).

    cuDNN runs fp32 convolutions in TF32 by default, which keeps about three
    decimal digits; the golden scores are held to 1e-3.  The other cuDNN
    flags keep their current values.  bf16 convolutions are not affected.
    """
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


@contextlib.contextmanager
def deterministic_fp32():
    """:func:`exact_fp32` with cuDNN's deterministic algorithms and no
    benchmark search inside the block: the block's backward gives the same
    bits run to run, as a JAX step does on one device.

    Without it, cuDNN's fp32 backward of the 1x1 and the full 3x3
    convolutions (their weight gradients, and the data gradient of the
    stride-2 3x3) sums partial products in an order that changes from run
    to run: two train or QAT runs from one state part at the first step
    (measured on an H100 with ``tools/torch_determinism_check.py
    --find-op``; the loss, BatchNorm and the depthwise convolutions did not
    differ).  The flags are restored on exit; the CPU does not read them.
    """
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                     allow_tf32=False):
        yield
