"""The decoder transformer substrate: configuration schema, layers, GQA
attention and the dense decoder (prefill, decode)."""
