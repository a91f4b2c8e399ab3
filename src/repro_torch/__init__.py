"""PyTorch port of the Fograph GNN fog-serving reproduction.

Mirrors the JAX package's layout (``gnn``, ``core``, ``kernels``,
``runtime``, ``api``); its block-CSR aggregation kernels are hand-written
CUDA for Hopper. The serving entry point is
``repro_torch.api.Engine(model, cluster, device="cuda")``.
"""
