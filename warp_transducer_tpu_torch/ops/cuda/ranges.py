"""Wrapper of the range kernel (``csrc/ranges.cu``), the counterpart of the
three ``lax.scan``s of ``warp_transducer_tpu/ops/pruned.py::
ranges_from_posteriors``. The plain version is ``ops/band.py::band_starts``;
the posterior argmax before it stays a torch op on every device."""
from __future__ import annotations

import torch

from .. import band as _plain
from . import SMEM_BYTES, check, lib, require, stream


def band_starts(best_u: torch.Tensor, input_lengths: torch.Tensor,
                label_lengths: torch.Tensor, s_range: int) -> torch.Tensor:
    """``band.band_starts`` on the card: one block per utterance. On a CPU
    tensor this is the plain version."""
    if best_u.device.type != "cuda":
        return _plain.band_starts(best_u, input_lengths, label_lengths, s_range)
    S = int(s_range)
    if S < 2:
        raise ValueError(f"s_range must be >= 2, got {S}")
    dev = best_u.device
    require(best_u, "best_u", dev, (torch.int32,), 2)
    B, T = best_u.shape
    if T < 1:
        raise ValueError(f"best_u must have T >= 1 frames; got {T}")
    if T * 4 > SMEM_BYTES:  # one utterance's T starts
        raise ValueError(f"T={T} exceeds the range kernel's limit of {SMEM_BYTES // 4} frames")
    il, ll = (x.to(device=dev, dtype=torch.int32).contiguous()
              for x in (input_lengths, label_lengths))
    ranges = torch.empty_like(best_u)
    with torch.cuda.device(dev):
        err = lib().wtt_band_starts(best_u.data_ptr(), il.data_ptr(), ll.data_ptr(),
                                    ranges.data_ptr(), B, T, S, stream(dev))
    check(err, "ranges")
    return ranges
