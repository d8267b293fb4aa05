"""Quickstart on the PyTorch port: build a Semantic Histogram and estimate
filter selectivities (``examples/quickstart.py`` through ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The histogram's probe and the medoid sample's k-means assignment run the
port's CUDA kernels on the card (the default), their plain versions with
``--device cpu``.
"""

import argparse

import torch

from repro_torch.configs.paper_stack import SpecificityModelConfig
from repro_torch.core.histogram import SemanticHistogram
from repro_torch.core.kvbatch import threshold_from_matches
from repro_torch.core.metrics import q_error
from repro_torch.core.specificity import train_specificity
from repro_torch.core.synthetic import make_corpus, specificity_dataset
from repro_torch.device import resolve_device
from repro_torch.kernels.kmeans.ops import medoid_sample


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--images", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a synthetic image corpus with an exact concept hierarchy
    corpus = make_corpus("wildlife", n_images=args.images, seed=0)
    print(f"corpus: {len(corpus.images)} images, "
          f"{len(corpus.concepts)} concepts, dim={corpus.dim}")

    # 2. the Semantic Histogram = all image embeddings, probed in one pass
    images = torch.as_tensor(corpus.images, device=dev)
    hist = SemanticHistogram(images)

    # 3a. specificity model (paper §3.1): predicate embedding -> threshold
    X, y = specificity_dataset(corpus, n_samples=1500, seed=0)
    model, metrics = train_specificity(
        X, y, SpecificityModelConfig(embed_dim=corpus.dim, steps=args.steps),
        device=dev)
    print(f"specificity model trained: val_mae={metrics['val_mae']:.4f}")

    # 3b. threshold from a diverse sample (paper §3.2, calibration part)
    sample = medoid_sample(images, 128, iters=5, seed=0)

    n = len(corpus.images)
    print(f"\n{'predicate':>10s} {'true':>8s} {'spec-model':>12s} "
          f"{'kv-thresh':>12s} {'ensemble':>10s}")
    for nid in corpus.predicate_nodes(max_per_depth=2)[:10]:
        true = corpus.true_selectivity(nid)
        emb = corpus.text_embedding(nid)
        t1 = model.threshold(emb)
        m = int(corpus.vlm_answer(nid, sample).sum())
        t2 = threshold_from_matches(1.0 - corpus.images[sample] @ emb, m)
        s1 = hist.selectivity(emb, t1)
        s2 = hist.selectivity(emb, t2)
        s3 = hist.selectivity(emb, 0.5 * (t1 + t2))
        print(f"node {nid:4d} {true:8.4f} "
              f"{s1:7.4f} (q{q_error(s1, true, n):4.1f}) "
              f"{s2:7.4f} (q{q_error(s2, true, n):4.1f}) "
              f"{s3:7.4f} (q{q_error(s3, true, n):4.1f})")


if __name__ == "__main__":
    main()
