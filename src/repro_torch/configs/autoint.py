"""autoint [arXiv:1810.11921]: 39 sparse fields, embed_dim=16, 3 attn layers,
2 heads, d_attn=32, self-attention feature interaction."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.recsys import AutoIntConfig

CONFIG = AutoIntConfig(name="autoint", n_fields=39, rows_per_table=1_000_000,
                       embed_dim=16, n_attn_layers=3, n_heads=2, d_attn=32)
SMOKE = AutoIntConfig(name="autoint-smoke", n_fields=8, rows_per_table=1000,
                      embed_dim=8, n_attn_layers=2, n_heads=2, d_attn=8,
                      n_multihot=2, hot_per_field=4)
ARCH = ArchDef(name="autoint", family="recsys", config=CONFIG, smoke_config=SMOKE)
