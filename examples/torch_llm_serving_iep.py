"""Beyond the paper: Fograph's placement machinery scheduling LLM serving,
on the PyTorch port.

Requests = data points, pods = fog nodes: the proxy-guided profiler fits
omega(<batch, cache_tokens>) per pod and the LBAP bottleneck solver places
request batches (src/repro_torch/launch/serve.py is the full program).
Runs on a CUDA card; pass ``--device cpu`` to run on the CPU.

    PYTHONPATH=src python examples/torch_llm_serving_iep.py [--device cpu]
"""
import sys

from repro_torch.launch.serve import main

raise SystemExit(main(["--arch", "qwen1.5-0.5b", "--requests", "12",
                       "--tokens", "12", "--pods", "1.0,2.0,3.0",
                       *sys.argv[1:]]))
