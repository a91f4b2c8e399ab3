"""Graphs, datasets, GNN layers and models."""
