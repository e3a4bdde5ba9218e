"""The card's peaks and the least time a piece of work can take on it.

NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the 700 W power
limit): HBM3 at 3.35 TB/s; 495 TFLOP/s in TF32 on the tensor cores, so
fp32-accurate products by the three-product split (3×TF32) at 495/3 TFLOP/s.
A run states the card's name and power limit beside the shares it reports.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
TF32_FLOPS = 495e12
FP32_EXACT_MMA_FLOPS = TF32_FLOPS / 3  # fp32 accuracy on the tensor cores (3×TF32)


def least_seconds(flops: float, nbytes: float, peak_flops: float) -> float:
    """The larger of ``flops`` at ``peak_flops`` and ``nbytes`` at the HBM
    rate."""
    return max(flops / peak_flops, nbytes / HBM_BYTES_S)


def share(work, device_s: float, peak_flops: float):
    """Per cent of its roofline that the kernel ran at: the least time of
    ``work`` (a list of (flops, bytes), one a launch) over the device
    seconds the launches took; None when there is nothing to read."""
    if not work or device_s <= 0:
        return None
    least = sum(least_seconds(f, b, peak_flops) for f, b in work)
    return 100.0 * least / device_s


def kernel_share(run, patterns, work, peak_flops: float):
    """:func:`share` of the device operations whose name holds one of
    ``patterns`` in ``run``'s trace, against ``work``; None when the run was
    not traced, the kernel did not run, or its launches do not match the
    calls the work was counted from (``work`` then has another length)."""
    from specbench.trace import kernel_seconds

    if run.trace is None:
        return None
    seconds, launches = kernel_seconds(run.trace, patterns)
    if launches == 0 or launches != len(work):
        return None
    return share(work, seconds, peak_flops)
