"""End-to-end driver on the PyTorch port, as ``examples/train_lm.py``:
train a ~100M-parameter LM for a few hundred steps, with
Polytope-planned token batches (on the card one union read a step from
the corpus on the device), checkpointing and a simulated preemption +
restart.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300   # the card
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
      --preset small --steps 60
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
from repro_torch.dataplane.tokens import TokenCube
from repro_torch.models.transformer import (TransformerConfig, init_params,
                                            loss_fn)
from repro_torch.train.fault import FaultConfig, Supervisor
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_state import init_train_state, make_train_step


def lm_100m() -> TransformerConfig:
    # ~100M params: 12 layers × d512 × ff2048, 32k vocab
    return TransformerConfig(
        name="lm-100m", vocab=32_768, d_model=512, n_layers=12,
        n_heads=8, n_kv_heads=4, d_head=64, d_ff=2048, q_chunk=None)


def lm_small() -> TransformerConfig:
    # CPU-budget variant for CI / laptops (same code path)
    return TransformerConfig(
        name="lm-small", vocab=4096, d_model=128, n_layers=4,
        n_heads=4, n_kv_heads=2, d_head=32, d_ff=512, q_chunk=None)


def main(argv: list[str] | None = None) -> dict:
    """Train; returns what was printed: every step's loss (replayed
    steps again), the restarts and the parameter count."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm100m"))
    ap.add_argument("--preempt-at", type=int, default=-1,
                    help="simulate a node failure at this step")
    ap.add_argument("--preset", choices=["100m", "small"],
                    default="100m")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the weights' generator")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain "
                         "versions)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = lm_100m() if args.preset == "100m" else lm_small()
    # The train state's parameters: flat, keyed by the JAX tree's paths.
    params = carry.decoder_params(
        init_params(cfg, device=dev, seed=args.seed), cfg)
    n_params = sum(p.numel() for p in params.values())
    print(f"model: {n_params / 1e6:.1f}M params")

    ocfg = OptimizerConfig(kind="adamw", lr=3e-4, warmup_steps=50,
                           total_steps=args.steps)
    state = init_train_state(params, ocfg)
    step = make_train_step(
        lambda p, b: loss_fn(carry.decoder_tree(p, cfg), cfg, b["tokens"],
                             b["labels"]), ocfg)

    tc = TokenCube(vocab=cfg.vocab, n_docs=64, doc_len=1024, device=dev)

    def data_fn(s):
        # numpy from the CPU's plain path; tensors on the card
        b = tc.batch(s, args.batch, args.seq)
        return device_put(b, dev) if dev.type == "cpu" else b

    crashed = {"done": False}

    def injector(s):
        if s == args.preempt_at and not crashed["done"]:
            crashed["done"] = True
            print(f"!! simulated preemption at step {s}")
            raise RuntimeError("simulated preemption")

    t0 = time.time()
    losses = []

    def on_metrics(s, m):
        losses.append(float(m["loss"]))
        if s % 20 == 0:
            tok_s = args.batch * args.seq * (s + 1) / (time.time() - t0)
            print(f"step {s:4d}  loss {losses[-1]:.4f}  "
                  f"lr {float(m['lr']):.2e}  {tok_s:,.0f} tok/s")

    sup = Supervisor(FaultConfig(ckpt_dir=args.ckpt_dir, ckpt_every=50),
                     step, data_fn, fault_injector=injector)
    sup.run(state, args.steps, on_metrics=on_metrics)
    dt = time.time() - t0
    print(f"\nfinal loss {np.mean(losses[-10:]):.4f} "
          f"(start {np.mean(losses[:10]):.4f}); "
          f"{args.steps} steps in {dt:.1f}s; "
          f"restarts: {sup.restarts}")
    return {"device": str(dev), "n_params": n_params, "losses": losses,
            "first_loss": float(np.mean(losses[:10])),
            "final_loss": float(np.mean(losses[-10:])),
            "restarts": sup.restarts, "steps": args.steps, "seconds": dt}


if __name__ == "__main__":
    main()
