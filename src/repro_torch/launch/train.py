"""Training launcher: ``python -m repro_torch.launch.train --arch smollm-360m``.

The reference's launcher (``repro/launch/train.py``) on the port: config
registry -> model -> data pipeline -> fault-tolerant runner (watchdog,
retries, async checkpoints) -> AdamW or Adafactor. It runs on the card
unless ``--device cpu`` is given, and on the smoke config unless
``--no-smoke``. Each step prints the reference's line, the run its
summary; the run fails unless the loss fell.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import lm_data_iterator
from repro_torch.device import resolve_device
from repro_torch.models.steps import make_train_state, make_train_step
from repro_torch.runtime.fault_tolerance import FaultTolerantRunner


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--no-smoke", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What ``build`` makes of the arguments: run it with ``execute``."""

    cfg: object
    state: dict
    runner: FaultTolerantRunner
    data: object


def build(args: argparse.Namespace) -> TrainRun:
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = make_train_state(cfg, gen, dev)
    step_fn = make_train_step(cfg, num_microbatches=args.microbatches,
                              peak_lr=1e-3, total_steps=args.steps,
                              warmup=max(1, args.steps // 10))
    runner = FaultTolerantRunner(step_fn, CheckpointManager(args.ckpt_dir,
                                                            keep=2),
                                 checkpoint_every=args.ckpt_every)
    data = lm_data_iterator(cfg, shape, num_steps=args.steps, seed=args.seed,
                            device=dev)
    return TrainRun(cfg, state, runner, data)


def execute(run: TrainRun, on_step=None) -> dict:
    """Runs every step, printing the reference's per-step line and summary;
    ``on_step(step, metrics)`` sees each step's metrics. Returns {"losses",
    "steps", "seconds", "state"}; raises if the loss did not fall."""
    losses = []

    def on_metrics(step, metrics, verdict):
        loss = float(metrics["loss"])
        losses.append(loss)
        print(f"step {step:5d} loss {loss:8.4f} lr {float(metrics['lr']):.2e} "
              f"[{verdict}]", flush=True)
        if on_step is not None:
            on_step(step, metrics)

    t0 = time.time()
    state, final_step = run.runner.run(run.state, run.data,
                                       on_metrics=on_metrics)
    dt = time.time() - t0
    runner = run.runner
    print(f"done: {final_step} steps in {dt:.1f}s, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
          f"stragglers={runner.watchdog.stragglers} retries={runner.retries}",
          flush=True)
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"loss did not decrease: {losses[0]} -> "
                           f"{losses[-1]}")
    return {"losses": losses, "steps": final_step, "seconds": dt,
            "state": state}


def main(argv=None) -> None:
    execute(build(parse_args(argv)))


if __name__ == "__main__":
    main()
