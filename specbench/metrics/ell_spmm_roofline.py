"""Per cent of its roofline that ``ell_spmm`` (kernel B3, ``csrc/ell_spmm.cu``:
the slot pass and, above 8 columns, the band pass without the Chebyshev
epilogue) ran at over the traced window.  Work: :func:`specbench.work.spmm`
on the graph's distinct nonzero pairs and each call's block width (recorded
from ``BlockEllOperator.mm``); peak: 165 TFLOP/s (3×TF32) and 3.35 TB/s —
the product is memory-bound at every width the paths use."""
from specbench import peaks, work

NAMES = ("ell_spmm_stream", "ell_spmm_band<false")
CALLS = {"ell_spmm": ("repro_torch.core.operator:BlockEllOperator.mm",
                      lambda op, x, *a, **kw: (x.shape[1],))}


def read(run):
    s = run.sizes
    calls = [work.spmm(s["graph_pairs"], s["n"], b) for (b,) in run.calls.get("ell_spmm", [])]
    return peaks.kernel_share(run, NAMES, calls, peaks.FP32_EXACT_MMA_FLOPS)
