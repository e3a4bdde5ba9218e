"""Optimizers and gradient compression (mirrors :mod:`repro.optim`; the
compressed all-reduce ``compressed_psum_mean`` comes with ROADMAP A14e)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.compress import compress_int8, decompress_int8  # noqa: F401
