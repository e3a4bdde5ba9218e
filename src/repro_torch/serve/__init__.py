"""Serving (mirrors :mod:`repro.serve`).  Only the label-agreement metric is
ported so far; the out-of-sample extension, batcher, stream and registry are
ROADMAP A10."""
