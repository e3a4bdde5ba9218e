"""glm4-9b [hf:THUDM/glm-4-9b]: 40L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=151552 — RoPE, GQA."""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="glm4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_head=128,
    d_ff=13696,
    vocab=151552,
    rope_theta=10000.0,
    dtype=torch.bfloat16,
    attn_chunk=2048,
)

SMOKE = TransformerConfig(
    name="glm4-9b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab=512,
    dtype=torch.float32,
    attn_chunk=64,
)

ARCH = ArchDef(name="glm4-9b", family="lm", config=CONFIG, smoke_config=SMOKE,
               sub_quadratic=False)
