"""What a run draws from its seed before the program sees anything: the
corpus, the specificity MLP's weights and the KV-batch sample. Both the
program and the reference take these; nothing here imports the
program."""

from __future__ import annotations

import torch

from semhist_bench import corpus, weights


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys set, nested groups merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def build_inputs(cfg: dict, seed: int, dev: torch.device):
    """The corpus, the MLP's weights and the KV-batch sample, from the
    seed: the inputs both the program and the reference take."""
    tree = corpus.build_tree(cfg["preset"], int(cfg["rows"]),
                             int(cfg["dim"]), seed, int(cfg["shape_seed"]))
    store = corpus.make_images(tree, seed, dev)
    sp = cfg["specificity"]
    X, y = corpus.specificity_labels(tree, store, samples=int(sp["samples"]),
                                     subset=int(sp["subset"]), seed=seed)
    params = weights.train_specificity(
        X, y, hidden=list(cfg["mlp_hidden"]), steps=int(sp["steps"]),
        batch=int(sp["batch"]), lr=float(sp["lr"]), seed=seed, device=dev)
    kv = cfg["kvbatch"]
    sample = corpus.medoid_sample(store, int(kv["sample"]),
                                  iters=int(kv["kmeans_iters"]), seed=seed)
    return tree, store, params, sample
