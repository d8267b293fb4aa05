"""What a run draws from its seed before the program sees anything: the
corpus, the specificity MLP's weights and the KV-batch sample. Both the
program and the reference take these; nothing here imports the
program."""

from __future__ import annotations

import numpy as np
import torch

from semhist_bench import corpus, weights


def merge(base: dict, over: dict) -> dict:
    """``base`` with ``over``'s keys set, nested groups merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def build_corpus(cfg: dict, seed: int, dev: torch.device):
    """The concept tree and the device store."""
    tree = corpus.build_tree(cfg["preset"], int(cfg["rows"]),
                             int(cfg["dim"]), seed, int(cfg["shape_seed"]))
    return tree, corpus.make_images(tree, seed, dev)


def kv_sample(cfg: dict, store: torch.Tensor, seed: int):
    """The KV-batch sample's row ids."""
    kv = cfg["kvbatch"]
    return corpus.medoid_sample(store, int(kv["sample"]),
                                iters=int(kv["kmeans_iters"]), seed=seed)


def sample_rows(store: torch.Tensor, sample) -> np.ndarray:
    """The sample's rows of the store, on the host: the image embeddings
    the KV-batch VLM's patches are lifted from."""
    return store[torch.as_tensor(sample, device=store.device)].cpu().numpy()


def vlm_sample(cfg: dict, seed: int, dev: torch.device):
    """The KV-batch sample's ids and rows, as a run draws them: what the
    VLM's build and its reference take, without the MLP's training."""
    _, store = build_corpus(cfg, seed, dev)
    sample = kv_sample(cfg, store, seed)
    return sample, sample_rows(store, sample)


def build_inputs(cfg: dict, seed: int, dev: torch.device):
    """The corpus, the MLP's weights and the KV-batch sample, from the
    seed: the inputs both the program and the reference take. The
    KV-batch VLM's own draws are ``vlmdraw``'s."""
    tree, store = build_corpus(cfg, seed, dev)
    sp = cfg["specificity"]
    X, y = corpus.specificity_labels(tree, store, samples=int(sp["samples"]),
                                     subset=int(sp["subset"]), seed=seed)
    params = weights.train_specificity(
        X, y, hidden=list(cfg["mlp_hidden"]), steps=int(sp["steps"]),
        batch=int(sp["batch"]), lr=float(sp["lr"]), seed=seed, device=dev)
    return tree, store, params, kv_sample(cfg, store, seed)
