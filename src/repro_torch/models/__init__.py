"""Model zoo (mirrors :mod:`repro.models`): the LM, GNN and recsys families.

  transformer.py — dense LMs (glm4-9b, qwen2-7b, qwen3-0.6b) + MoE LMs
                   (granite-moe-3b-a800m, olmoe-1b-7b) via moe.py
  gnn/           — gcn-cora, pna, nequip, equiformer-v2 (+ the E(3)
                   substrate and the constant-memory edge-chunk backward)
  recsys.py      — AutoInt + EmbeddingBag
  common.py      — norms, rotary embeddings, attention

Every model is a pure-function pair (init, apply) over nested-dict params of
torch tensors.
"""
