"""Optimizers and gradient compression (mirrors :mod:`repro.optim`)."""

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.compress import (compress_int8, compressed_psum_mean,  # noqa: F401
                                        decompress_int8)
