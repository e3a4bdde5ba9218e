"""Sparse formats and ops on torch tensors (mirrors :mod:`repro.sparse`)."""
