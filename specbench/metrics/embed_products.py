"""Operator products a job: launches of ``ell_spmm``, ``ell_spmv`` and the
fused Chebyshev step in the window (their ``.launches`` counters, card
launches only), over the window's jobs."""

COUNTERS = {"ell_spmm": "repro_torch.kernels.ell_spmm.ops:ell_spmm",
            "ell_spmv": "repro_torch.kernels.ell_spmv.ops:ell_spmv",
            "ell_spmm_cheb": "repro_torch.kernels.ell_spmm.ops:ell_spmm_cheb_step"}


def read(run):
    if run.device == "cpu" or not run.jobs:
        return None
    return sum(run.launches[k] for k in COUNTERS) / len(run.jobs)
