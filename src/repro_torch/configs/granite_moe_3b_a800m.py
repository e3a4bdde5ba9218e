"""granite-moe-3b-a800m [hf:ibm-granite family]: 32L d_model=1536 24H (GQA
kv=8) expert d_ff=512 vocab=49155, MoE 40 experts top-8."""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_head=64,
    d_ff=0,
    vocab=49155,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    attn_chunk=2048,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
)

SMOKE = TransformerConfig(
    name="granite-moe-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=0,
    vocab=512,
    dtype=torch.float32,
    attn_chunk=64,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
)

ARCH = ArchDef(name="granite-moe-3b-a800m", family="lm", config=CONFIG, smoke_config=SMOKE)
