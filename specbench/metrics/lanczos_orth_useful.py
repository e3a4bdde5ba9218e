"""Per cent of the basis rows the Gram–Schmidt GEMMs multiply that hold a
vector: over the window's ``lanczos.orth`` spans, 100 × Σ ``filled`` (rows
of the basis nonzero at that step, j + b) ÷ Σ ``rows`` (rows multiplied,
m + b).  The rest are the zero rows a block step streams anyway."""
from specbench.metrics.lanczos_orth_s import spans_named


def read(run):
    kept = spans_named("lanczos.orth")
    rows = sum(r.attrs["rows"] for r in kept)
    return 100.0 * sum(r.attrs["filled"] for r in kept) / rows if rows else None
