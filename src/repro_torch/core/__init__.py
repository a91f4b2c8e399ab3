"""The paper's system: profiling, partitioning, placement, scheduling,
compression and the serving-latency simulator (host numpy)."""
