"""GNN family (mirrors :mod:`repro.models.gnn`): gcn-cora, pna, nequip,
equiformer-v2.

Message passing is built on ``index_add_`` and ``scatter_reduce`` over
edge-index tensors (plain PyTorch: no sparse message-passing library).
Three regimes are covered:

* SpMM-style aggregation       — gcn.py, pna.py
* E(3) irrep tensor products   — nequip.py (+ e3.py substrate)
* eSCN SO(2) convolutions      — equiformer_v2.py (Wigner rotation to the
                                 edge frame, O(L³) instead of O(L⁶) TP)

``chunked.py`` holds the constant-memory backward over edge chunks that
the full-graph cells of the two equivariant models run.
"""
