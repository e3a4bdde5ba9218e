"""Model zoo (mirrors :mod:`repro.models`): the LM and recsys families.

  transformer.py — dense LMs (glm4-9b, qwen2-7b, qwen3-0.6b) + MoE LMs
                   (granite-moe-3b-a800m, olmoe-1b-7b) via moe.py
  recsys.py      — AutoInt + EmbeddingBag
  common.py      — norms, rotary embeddings, attention

Every model is a pure-function pair (init, apply) over nested-dict params of
torch tensors.  The GNN family belongs to ROADMAP A14c.
"""
