"""gcn-cora [arXiv:1609.02907]: 2L d_hidden=16 mean aggregator, sym norm."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.gnn.gcn import GCNConfig

CONFIG = GCNConfig(name="gcn-cora", n_layers=2, d_hidden=16)
SMOKE = GCNConfig(name="gcn-cora-smoke", n_layers=2, d_in=32, d_hidden=8, n_classes=4)
ARCH = ArchDef(name="gcn-cora", family="gnn", config=CONFIG, smoke_config=SMOKE)
