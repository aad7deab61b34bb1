"""RecSys example on the PyTorch port, as ``examples/train_recsys.py``:
DLRM CTR training where every embedding lookup is a Polytope
categorical-axis extraction (EmbeddingBag = plan + exact-byte gather +
segment-sum; on the card the bag-sum kernel, forward and through its
backward), with checkpoint/restart fault tolerance.

  PYTHONPATH=src python examples/torch_train_recsys.py --steps 200  # the card
  PYTHONPATH=src python examples/torch_train_recsys.py --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch import carry
from repro_torch._device import resolve_device
from repro_torch.dataplane.pipeline import device_put
from repro_torch.dataplane.recsys import ClickStream
from repro_torch.models.recsys import DLRM, DLRMConfig, dlrm_loss
from repro_torch.train.fault import FaultConfig, Supervisor
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_state import init_train_state, make_train_step


def main(argv: list[str] | None = None) -> dict:
    """Train; returns what was printed: every step's BCE and the
    restarts."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_dlrm"))
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights' generator")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = DLRMConfig(rows=50_000, embed_dim=16, n_sparse=8,
                     bot_mlp=(64, 32, 16), top_mlp=(64, 32, 1))
    model = DLRM(cfg, device=dev, seed=args.seed)
    ocfg = OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=20,
                           total_steps=args.steps)
    state = init_train_state(carry.model_params(model), ocfg)
    step = make_train_step(lambda p, b: (dlrm_loss(model, b), {}), ocfg)

    cs = ClickStream(n_sparse=cfg.n_sparse, rows=cfg.rows)

    def data_fn(s):
        return device_put(cs.batch(s, args.batch), dev)

    t0 = time.time()
    losses = []

    def on_metrics(s, m):
        losses.append(float(m["loss"]))
        if s % 25 == 0:
            print(f"step {s:4d}  bce {losses[-1]:.4f}")

    sup = Supervisor(FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50),
                     step, data_fn)
    sup.run(state, args.steps, on_metrics=on_metrics)
    dt = time.time() - t0
    print(f"\nBCE {np.mean(losses[:10]):.4f} → "
          f"{np.mean(losses[-10:]):.4f} over {args.steps} steps "
          f"({dt:.1f}s); AUC-proxy improving ⇢ the hidden "
          f"CTR model is being learned through extracted embeddings")
    return {"device": str(dev), "losses": losses,
            "first_loss": float(np.mean(losses[:10])),
            "final_loss": float(np.mean(losses[-10:])),
            "restarts": sup.restarts, "steps": args.steps, "seconds": dt}


if __name__ == "__main__":
    main()
