"""The band schedule of the banded remap DP (cf.
``sloika_tpu/ops/remap_banded.py``).

At frame ``t`` the DP of row ``b`` covers the ``W`` positions
``[s_b(t), s_b(t) + W)``, centred on the linear frame -> position
interpolation of that row.  The kernel that runs the banded DP is
:mod:`sloika_tpu_torch.ops.remap_kernel`.
"""
import torch


def band_starts(nframes, npos, T, W):
    """(T, B) int32 window starts (sloika_tpu/ops/remap_banded.py:37), on
    the device of ``nframes``.

    Monotone with per-step increments in {0, 1}: the raw ramp
    ``clip(round(frac * (npos-1)) - W//2, 0, npos-W)`` is capped by the
    closed form ``starts_t = t + cummin_{u<=t}(raw_u - u)``, exact whenever
    the slope ``(npos-1)/(nframes-1) <= 1`` (frames outnumber positions).

    :param nframes, npos: (B,) true frame and sequence lengths
    """
    dev = nframes.device
    t = torch.arange(T, dtype=torch.float32, device=dev)[:, None]
    nf = torch.clamp(nframes.to(torch.float32) - 1.0, min=1.0)[None, :]
    npos_f = npos.to(torch.float32)[None, :]
    frac = torch.clamp(t / nf, max=1.0)
    centre = torch.round(frac * (npos_f - 1.0)).to(torch.int32)
    hi = torch.clamp(npos.to(torch.int32) - W, min=0)[None, :]
    raw = torch.minimum(torch.clamp(centre - W // 2, min=0), hi)
    ti = torch.arange(T, dtype=torch.int32, device=dev)[:, None]
    adj = torch.cummin(raw - ti, dim=0).values
    return ti + adj
