"""nequip [arXiv:2101.03164]: 5L d_hidden=32 l_max=2 n_rbf=8 cutoff=5,
E(3) tensor products."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.gnn.nequip import NequIPConfig

CONFIG = NequIPConfig(name="nequip", n_layers=5, channels=32, l_max=2, n_rbf=8,
                      cutoff=5.0, edge_chunk=1 << 20)
SMOKE = NequIPConfig(name="nequip-smoke", n_layers=2, channels=8, l_max=2,
                     n_rbf=4, n_species=5)
ARCH = ArchDef(
    name="nequip", family="gnn", config=CONFIG, smoke_config=SMOKE,
    notes="Non-geometric cells (citation graphs) get synthesized positions/"
          "species stand-ins; see DESIGN.md §Arch-applicability.")
