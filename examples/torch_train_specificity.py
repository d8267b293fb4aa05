"""Train the specificity model on the PyTorch port, checkpoint it with the
port's ``CheckpointManager`` and restore it: ``examples/train_specificity
.py`` through ``repro_torch``.

    PYTHONPATH=src python examples/torch_train_specificity.py [--device cpu]
"""

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.paper_stack import SpecificityModelConfig
from repro_torch.core.specificity import train_specificity
from repro_torch.core.synthetic import make_corpus, specificity_dataset
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=800)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    corpus = make_corpus("wildlife", n_images=1000, seed=0)
    X, y = specificity_dataset(corpus, n_samples=4000, seed=0)
    cfg = SpecificityModelConfig(embed_dim=X.shape[1], steps=args.steps)
    model, metrics = train_specificity(X, y, cfg, device=dev)
    print(f"trained {cfg.steps} steps in {metrics['train_s']:.1f}s  "
          f"val_mae={metrics['val_mae']:.4f}")

    params = dict(model.module.named_parameters())
    want = model.thresholds(X[:4])
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d, keep=2)
        ckpt.save(cfg.steps, params)
        restored = ckpt.restore(None, like=params)
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(restored[name])
    got = model.thresholds(X[:4])
    print("restored-model thresholds for 4 predicates:", np.round(got, 4))
    if not np.array_equal(got, want):
        raise RuntimeError("the restored model's thresholds differ")


if __name__ == "__main__":
    main()
