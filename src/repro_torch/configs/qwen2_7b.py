"""qwen2-7b [arXiv:2407.10671]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias."""
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="qwen2-7b",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    dtype=torch.bfloat16,
    attn_chunk=2048,
)

SMOKE = TransformerConfig(
    name="qwen2-7b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    d_head=32,
    d_ff=256,
    vocab=512,
    qkv_bias=True,
    dtype=torch.float32,
    attn_chunk=64,
)

ARCH = ArchDef(name="qwen2-7b", family="lm", config=CONFIG, smoke_config=SMOKE)
