"""pna [arXiv:2004.05718]: 4L d_hidden=75, aggregators mean-max-min-std,
scalers id-amp-atten."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.gnn.pna import PNAConfig

CONFIG = PNAConfig(name="pna", n_layers=4, d_hidden=75)
SMOKE = PNAConfig(name="pna-smoke", n_layers=2, d_in=32, d_hidden=12, n_classes=4)
ARCH = ArchDef(name="pna", family="gnn", config=CONFIG, smoke_config=SMOKE)
