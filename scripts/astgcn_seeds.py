#!/usr/bin/env python3
"""How often ASTGCN-lite's training diverges, in both packages (CPU),
and how far a float32 run lies from float64 (``--drift``).

    python3 scripts/astgcn_seeds.py [--inits 20] [--steps 300]
    python3 scripts/astgcn_seeds.py --drift [--steps 300]

Trains ASTGCN-lite on ``load_pems_window(1.0, seed=0)`` at the trainers'
defaults (lr 1e-3, hidden 32) for ``--steps`` steps (the case-study
example's 300) from ``--inits`` inits in each package: the JAX package's
``train_astgcn(PRNGKey(k))`` and the port's ``train_astgcn(torch.Generator()
.manual_seed(k))``, k = 0 .. inits - 1. The two draw different weights
from the same k (different generators); what is compared is how often
each diverges. Prints each final loss (a loss that is not finite or is
above 10, on targets z-scored to variance 1, counts as diverged) and one
JSON line. A one-off measurement, not a test; it imports both packages.

``--drift`` trains the port alone from the case-study example's init
(``astgcn_init`` from a CPU generator, seed 0) twice: ``train_astgcn`` in
float32, and the same SGD in float64. It prints the final loss and
``forecast_errors`` of each and their relative differences: how far
float32 rounding alone moves a 300-step run.
"""
import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

DIVERGED = 10.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inits", type=int, default=20)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--drift", action="store_true",
                    help="float32 against float64 from the example's init")
    args = ap.parse_args(argv)
    if args.drift:
        return drift(args.steps)

    import jax
    import torch

    from repro.gnn import datasets as jdata
    from repro.gnn import models as jmodels
    from repro_torch.gnn import datasets as tdata
    from repro_torch.gnn import models as tmodels

    runs = {
        "jax": (jdata.load_pems_window(1.0, seed=0),
                lambda k, tg: jmodels.train_astgcn(
                    jax.random.PRNGKey(k), tg, steps=args.steps)[2]),
        "port": (tdata.load_pems_window(1.0, seed=0),
                 lambda k, tg: tmodels.train_astgcn(
                     torch.Generator().manual_seed(k), tg,
                     steps=args.steps)[2])}
    record = {"steps": args.steps, "inits": args.inits}
    for name, (tg, train) in runs.items():
        losses = [float(train(k, tg)) for k in range(args.inits)]
        bad = [k for k, loss in enumerate(losses)
               if not (math.isfinite(loss) and loss <= DIVERGED)]
        record[name] = {"losses": losses, "diverged": bad}
        print(f"{name}: {len(bad)} of {args.inits} inits diverged "
              f"({bad}); final losses "
              f"{[round(x, 4) if math.isfinite(x) else x for x in losses]}",
              flush=True)
    print(json.dumps(record), flush=True)
    return 0


def drift(steps: int, lr: float = 1e-3) -> int:
    import torch

    from repro_torch.gnn import datasets, layers, models

    tg = datasets.load_pems_window(1.0, seed=0)
    t_in, _, feats = tg.history.shape
    init = models.astgcn_init(torch.Generator().manual_seed(0), feats, t_in,
                              tg.target.shape[0])
    edges = layers.EdgeList.from_graph(tg.graph)
    p32, (mu, sd), loss32 = models.train_astgcn(
        torch.Generator(), tg, steps=steps, lr=lr, init=init)
    p64 = {k: v.double().clone().requires_grad_() for k, v in init.items()}
    hist = torch.as_tensor(tg.history, dtype=torch.float64)
    y = torch.as_tensor((tg.target - mu) / sd, dtype=torch.float64)
    for _ in range(steps):
        loss64 = torch.mean((models.astgcn_apply(p64, hist, edges) - y) ** 2)
        grads = torch.autograd.grad(loss64, list(p64.values()))
        with torch.no_grad():
            for v, g in zip(p64.values(), grads):
                v.sub_(lr * g)

    def errors(params):
        with torch.no_grad():
            pred = models.astgcn_apply(params, tg.history, edges).numpy()
        return models.forecast_errors(pred * sd + mu, tg.target)
    got = {"loss": loss32, **errors(p32)}
    want = {"loss": float(loss64.detach()), **errors(p64)}
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in got}
    print(f"float32 {got}\nfloat64 {want}\nrelative {rel}", flush=True)
    print(json.dumps({"steps": steps, "float32": got, "float64": want,
                      "relative": rel}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
