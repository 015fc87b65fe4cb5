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
