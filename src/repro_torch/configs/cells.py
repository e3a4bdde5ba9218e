"""Per-arch training knobs of the launcher (mirrors the two constants of
:mod:`repro.configs.cells` that ``launch/train.py`` reads).

The reference's module also builds the dry-run cells (arch × shape →
a lowerable step with its shardings); those come with the sharding and
launch tooling, ROADMAP A14e.
"""
from __future__ import annotations

from repro_torch.optim.adamw import AdamWConfig

# microbatch accumulation per LM arch (activation-memory fit)
LM_ACCUM = {
    "glm4-9b": 8,
    "qwen2-7b": 8,
    "qwen3-0.6b": 2,
    "granite-moe-3b-a800m": 4,
    "olmoe-1b-7b": 4,
}

OPT_CFG = AdamWConfig(lr=3e-4)
