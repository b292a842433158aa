"""Where the port runs: the one device check every entry point shares.

``"meta"`` is accepted where a caller asks for it by name: tensors there
have shapes and dtypes and no storage, which is how the dry-run
(:mod:`repro_torch.launch.dryrun`) builds every cell without allocating.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``torch.device(device)``; a CUDA device must exist — no CPU carry-on.
    ``"meta"`` passes as it is (storage-free shapes, never a fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available; "
            "pass device='cpu' to run on the host")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda, cpu or "
                         "meta")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
