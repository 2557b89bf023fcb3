"""Carry data between the JAX package and this port.

The JAX package holds k-mer codes as ``(hi, lo)`` uint32 pairs and
bit-vectors as uint32 arrays; this port holds both as int64 tensors (the
same bits).  Windows are uint8 ``[m, W]`` in both, masks bool.  These
helpers convert numpy arrays, so the tests can feed both packages the same
seeded inputs and compare their outputs.
"""

from __future__ import annotations

import numpy as np
import torch

from approx_counter_tpu_torch.core.codec import join_code


def codes_to_torch(hi, lo, device="cpu") -> torch.Tensor:
    """``(hi, lo)`` uint32 code halves -> int64 code tensor."""
    return torch.from_numpy(join_code(hi, lo).view(np.int64).copy()).to(device)


def u32_from_torch(t: torch.Tensor) -> np.ndarray:
    """int64 tensor holding uint32 values -> uint32 numpy array."""
    return t.cpu().numpy().astype(np.uint32)


def windows_to_torch(windows_t, device="cpu") -> torch.Tensor:
    """uint8 ``[m, W]`` numpy windows -> contiguous uint8 tensor."""
    return torch.from_numpy(np.ascontiguousarray(windows_t, np.uint8)).to(device)


def mask_to_torch(mask, device="cpu") -> torch.Tensor:
    """bool/int numpy mask -> bool tensor."""
    return torch.from_numpy(np.asarray(mask).astype(bool)).to(device)
