"""equiformer-v2 [arXiv:2306.12059]: 12L d_hidden=128 l_max=6 m_max=2 8H,
SO(2)-eSCN equivariant graph attention."""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2Config

# bf16 node features (fp32 Wigner/SH internals): the full-graph cells'
# transient node buffers halve; f32 stays the smoke/test dtype
CONFIG = EquiformerV2Config(name="equiformer-v2", n_layers=12, channels=128,
                            l_max=6, m_max=2, n_heads=8, edge_chunk=1 << 18,
                            dtype=torch.bfloat16)
SMOKE = EquiformerV2Config(name="equiformer-v2-smoke", n_layers=2, channels=16,
                           l_max=2, m_max=1, n_heads=2, n_species=5)
ARCH = ArchDef(
    name="equiformer-v2", family="gnn", config=CONFIG, smoke_config=SMOKE,
    notes="Non-geometric cells get synthesized positions/species stand-ins.")
