"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when ``cuda`` is asked for (explicitly or by default)
    and no card is present — there is no silent CPU fallback.

    On the card this switches TF32 off for matmuls and cuDNN convolutions:
    k-means labels and kNN ids are compared against fp32 references, and
    TF32 keeps only ~3 decimal digits.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch entry points run on the GPU by default, but "
                "torch.cuda.is_available() is False — pass device='cpu' to "
                "run the plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def cpu_generator(seed: int) -> torch.Generator:
    """A CPU generator: the port's entry points take one and draw from it only
    the key of a counter-based stream (:mod:`repro_torch._random`), which
    draws on the compute device and gives the same bits on the CPU and on
    the card."""
    return torch.Generator(device="cpu").manual_seed(int(seed))


def fold_in(gen: torch.Generator, data: int) -> torch.Generator:
    """A generator derived from ``gen``'s seed and ``data`` (the port's
    ``jax.random.fold_in``): deterministic, independent of how far ``gen``
    has been consumed."""
    return cpu_generator((gen.initial_seed() * 1_000_003 + int(data)) % (1 << 63))

