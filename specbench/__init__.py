"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command runs
one cell once (``python specbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>``).

Everything that measures lives here and is found by name
(:mod:`specbench.harness`): a configuration in ``configs/<name>.json``, its
data maker in ``datasets/<maker>.py``, a traffic mix in
``traffic/<name>.json`` with its job loop in ``loops/<loop>.py``, a
per-layer metric in ``metrics/<name>.py`` (a reader of its own), the plain
reference in ``reference/``; :mod:`specbench.runner` times, reads and
checks.  Nothing here imports ``jax`` or the JAX package, and the reference
imports nothing of the port.
"""
