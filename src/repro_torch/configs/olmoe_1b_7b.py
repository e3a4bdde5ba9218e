"""olmoe-1b-7b [arXiv:2409.02060]: 16L d_model=2048 16H (GQA kv=16) expert
d_ff=1024 vocab=50304, MoE 64 experts top-8."""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="olmoe-1b-7b",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=0,
    vocab=50304,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    attn_chunk=2048,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
)

SMOKE = TransformerConfig(
    name="olmoe-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    d_head=32,
    d_ff=0,
    vocab=512,
    dtype=torch.float32,
    attn_chunk=64,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
)

ARCH = ArchDef(name="olmoe-1b-7b", family="lm", config=CONFIG, smoke_config=SMOKE)
