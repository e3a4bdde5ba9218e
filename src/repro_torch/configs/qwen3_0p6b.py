"""qwen3-0.6b [hf:Qwen/Qwen3-0.6B family]: 28L d_model=1024 16H (GQA kv=8)
d_ff=3072 vocab=151936 — qk_norm, GQA."""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-0.6b",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_head=64,
    d_ff=3072,
    vocab=151936,
    qk_norm=True,
    rope_theta=1000000.0,
    dtype=torch.bfloat16,
    attn_chunk=2048,
)

SMOKE = TransformerConfig(
    name="qwen3-0.6b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab=512,
    qk_norm=True,
    dtype=torch.float32,
    attn_chunk=64,
)

ARCH = ArchDef(name="qwen3-0.6b", family="lm", config=CONFIG, smoke_config=SMOKE)
