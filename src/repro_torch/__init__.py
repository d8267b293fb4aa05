"""PyTorch/CUDA port of the Semantic-Histogram selectivity estimator.

``repro`` (JAX) is the reference; this package mirrors its subpackage and
module names so each counterpart is easy to find. It imports ``torch`` and
never ``jax``, and nothing of ``repro``. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"`` (see ``repro_torch.device``); the two
hand-written Hopper kernels (``kernels/cosine_topk``, ``kernels/kmeans``)
are built from ``csrc/*.cu`` at first use.
"""

import torch

# The store, predicates, thresholds and every probe output are float32, as
# in the reference; the CUDA kernels take nothing else.
DTYPE = torch.float32
