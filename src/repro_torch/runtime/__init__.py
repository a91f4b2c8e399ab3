"""Distributed BSP runtime: per-partition layouts and exchanges."""
