"""Per cent of its roofline that the fused Lloyd iteration ``kmeans_iter``
(kernel B2, ``csrc/kmeans_iter.cu``) ran at over the traced window.  Work:
:func:`specbench.work.kmeans_iter` at each call's (n, d, k), recorded from
``repro_torch.core.kmeans.lloyd_iter``; peak: fp32-accurate products on the
tensor cores (3×TF32, 495/3 TFLOP/s) and 3.35 TB/s."""
from specbench import peaks, work

CALLS = {"kmeans_iter": ("repro_torch.core.kmeans:lloyd_iter",
                         lambda x, c, *a, **kw: (x.shape[0], x.shape[1], c.shape[0]))}


def read(run):
    calls = [work.kmeans_iter(*shape) for shape in run.calls.get("kmeans_iter", [])]
    return peaks.kernel_share(run, ("kmeans_iter_kernel",), calls, peaks.FP32_EXACT_MMA_FLOPS)
