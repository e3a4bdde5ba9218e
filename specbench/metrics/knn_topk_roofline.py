"""Per cent of its roofline that ``knn_topk`` (kernel B1, ``csrc/knn_topk.cu``)
ran at over the traced window.  Work: :func:`specbench.work.knn_topk`, the
points in and the lists out (no operation count binds every correct exact
kNN in 3 dimensions), so the bound is HBM's 3.35 TB/s; one launch of the
tile kernel a call (the merge kernel, at more than one slice, adds its
time)."""
from specbench import peaks, work

TILE = ("knn_topk_kernel",)
ALL = ("knn_topk_kernel", "knn_merge_kernel")
COUNTERS = {"knn_topk": "repro_torch.kernels.knn_topk.ops:knn_topk"}


def read(run):
    if run.trace is None:
        return None
    from specbench.trace import kernel_seconds

    seconds, _ = kernel_seconds(run.trace, ALL)
    _, launches = kernel_seconds(run.trace, TILE)
    calls = run.launches["knn_topk"]
    if launches == 0 or launches != calls:
        return None
    s = run.sizes
    return peaks.share([work.knn_topk(s["n"], s["d_points"], s["knn_k"])] * calls, seconds,
                       peaks.FP32_EXACT_MMA_FLOPS)
