"""The paper's own architecture: the spectral clustering pipeline, with the
paper's four datasets (Table II) as shapes."""
import dataclasses

from repro_torch.configs.base import ArchDef
from repro_torch.core.pipeline import SpectralClusteringConfig  # noqa: F401  (re-export)


@dataclasses.dataclass(frozen=True)
class SpectralArchConfig:
    # k (clusters) comes from the shape; these are solver knobs
    lanczos_tol: float = 1e-5
    fixed_restarts: int = 2  # static-cost mode
    fixed_kmeans_iters: int = 2
    name: str = "spectral"


CONFIG = SpectralArchConfig()
SMOKE = SpectralArchConfig(name="spectral-smoke")
ARCH = ArchDef(name="spectral", family="spectral", config=CONFIG, smoke_config=SMOKE)
