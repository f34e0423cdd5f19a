"""Where the port's arrays live: the device an entry point runs on, and
host or device arrays turned into tensors there."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one, raise instead of silently
    running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU unless asked otherwise, and no CUDA "
            "device is available; pass device='cpu' to run on the CPU")
    return dev


def as_tensor(a, device: torch.device, dtype=None) -> torch.Tensor:
    """Host or device array → contiguous tensor on ``device``. Float64
    numpy input becomes float32, as ``jnp.asarray`` does without x64; a
    float64 tensor stays float64 (solved with the plain versions)."""
    if isinstance(a, torch.Tensor):
        t = a
    else:
        arr = np.asarray(a)
        if dtype is None and arr.dtype != np.float32:
            arr = arr.astype(np.float32)
        if not arr.flags.writeable:      # e.g. a view of a jax array
            arr = arr.copy()
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()
