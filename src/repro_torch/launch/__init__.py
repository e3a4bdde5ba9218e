"""Launcher layer (mirrors :mod:`repro.launch`): the logical-axis sharding
rules and the mesh, the training and serving launchers, and the dry-run
with its roofline and report."""
