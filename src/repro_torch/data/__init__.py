"""Synthetic inputs (mirrors :mod:`repro.data`): numpy generators that give
arrays identical to the reference's for the same seed."""
