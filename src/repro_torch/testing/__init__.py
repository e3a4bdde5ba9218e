"""Test-support package: fault injection for the fail-soft pipeline (mirrors
:mod:`repro.testing`).  Kept lazy — import :mod:`repro_torch.testing.faults`
explicitly."""
