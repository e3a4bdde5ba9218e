"""The three stages of the pipeline on torch tensors (mirrors :mod:`repro.core`).

NOTE: ``repro_torch.core.kmeans`` (module) contains ``kmeans`` (function) —
not re-exported here, so the function does not shadow the submodule.
"""
