"""Device resolution for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; asking
for CUDA where there is none raises instead of falling back.  Resolving a
device also pins float32 matrix products and convolutions to full float32:
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` are both set False, so an f32 run on
the card rounds like the CPU reference and not like TF32 (10-bit
mantissa).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
