"""Launcher layer (mirrors :mod:`repro.launch`): the serving launcher, LM
decode included.  The mesh, sharding, dry-run and training launchers belong
to ROADMAP A14b and A14e."""
