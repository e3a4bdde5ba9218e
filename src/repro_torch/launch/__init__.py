"""Launcher layer (mirrors :mod:`repro.launch`): the serving launcher.  The
mesh, sharding, dry-run and training launchers belong to ROADMAP A14."""
