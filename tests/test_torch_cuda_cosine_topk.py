"""The probe kernel (``repro_torch.kernels.cosine_topk``) against its plain
version on the card, at the reference kernel test's shapes: counts exactly
equal — every threshold sits in a gap between two adjacent row distances —
and top-k within 1e-4, the tolerance the Pallas kernel itself is held to.
Free of JAX, so it runs on a machine with a card and no JAX; the plain
version is held to the reference by ``test_torch_cosine_topk.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.cosine_topk import ops, ref  # noqa: E402

SHAPES = [(1000, 1152, 5, 16), (4096, 768, 1, 128), (257, 96, 3, 8),
          (128, 128, 2, 128)]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def gap_thresholds(store, preds, t, rng, min_gap=2e-6):
    """(B, T) f32 thresholds, each the midpoint of a gap >= ``min_gap``
    between two adjacent row distances (float64), so no f32 rounding of a
    distance can move a row across one."""
    d = 1.0 - preds.astype(np.float64) @ store.astype(np.float64).T
    n = store.shape[0]
    out = np.empty((len(preds), t), np.float32)
    for b in range(len(preds)):
        s = np.sort(d[b])
        ok = np.nonzero(np.diff(s) > min_gap)[0]
        for j, target in enumerate(np.sort(rng.uniform(0.02, 0.98, t))):
            i = ok[np.argmin(np.abs(ok - target * (n - 1)))]
            out[b, j] = 0.5 * (s[i] + s[i + 1])
    return out


def _case(n, d, b, t, seed):
    rng = np.random.default_rng(seed)
    store = _unit(rng, n, d)
    preds = _unit(rng, b, d)
    return store, preds, gap_thresholds(store, preds, t, rng)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernel has no CPU mode")
    for n, d, t, k in SHAPES:
        for b in (1, 7, 130):
            store, preds, thr = _case(n, d, b, t, seed=n + b)
            args = [torch.from_numpy(a).cuda() for a in (store, preds, thr)]
            kc, kt = ops.cosine_probe_batch(*args, k=k)
            pc, pt = ref.cosine_probe_batch_ref(*args, min(k, n))
            assert torch.equal(kc, pc)
            torch.testing.assert_close(kt, pt, rtol=1e-4, atol=1e-4)
            one_c, one_t = ops.cosine_probe(args[0], args[1][0], args[2][0],
                                            k=k)
            assert torch.equal(one_c, kc[0]) and torch.equal(one_t, kt[0])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "masked", "rowmask"])
def test_wide_launch_matches_plain_on_the_card(mode):
    """B > 8 (the wide launch: one store pass for any B) over the full
    store, a ragged ``n_valid`` and a row mask, k in {1, 8, 128} (a running
    list a CTA, and past 32 a list a staged block), T in {1, 4}: counts
    exactly the plain version's, top-k within 1e-4, and each predicate
    alone bitwise its row of the B = 200 batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernel has no CPU mode")
    for n, d in ((1000, 1152), (4099, 768)):
        rng = np.random.default_rng(n + d)
        store = _unit(rng, n, d)
        preds = _unit(rng, 200, d)
        thr = gap_thresholds(store, preds, 4, rng)
        st, pr, th = (torch.from_numpy(a).cuda() for a in (store, preds, thr))
        n_valid = n - n // 3 - 1
        mask = torch.from_numpy(
            (rng.random(n) < 0.6).astype(np.int32)).cuda()

        def kern(p, t, k):
            if mode == "full":
                return ops.cosine_probe_batch(st, p, t, k=k)
            if mode == "masked":
                return ops.cosine_probe_batch_masked(st, n_valid, p, t, k=k)
            return ops.cosine_probe_batch_rowmask(st, mask, p, t, k=k)

        def plain(p, t, k):
            if mode == "full":
                return ref.cosine_probe_batch_ref(st, p, t, k)
            if mode == "masked":
                return ref.cosine_probe_batch_masked_ref(st, n_valid, p, t, k)
            return ref.cosine_probe_batch_rowmask_ref(st, mask, p, t, k)

        def alone(j, k):
            if mode == "full":
                return ops.cosine_probe(st, pr[j], th[j], k=k)
            if mode == "masked":
                return ops.cosine_probe_masked(st, n_valid, pr[j], th[j], k=k)
            return ops.cosine_probe_rowmask(st, mask, pr[j], th[j], k=k)

        for b in (9, 37, 129, 200):
            for k in (1, 8, 128):
                for t in (1, 4):
                    p, tt = pr[:b].contiguous(), th[:b, -t:].contiguous()
                    kc, kt = kern(p, tt, k)
                    pc, pt = plain(p, tt, k)
                    assert torch.equal(kc, pc), (n, b, k, t)
                    fin = torch.isfinite(pt)
                    assert torch.equal(fin, torch.isfinite(kt))
                    torch.testing.assert_close(kt[fin], pt[fin], rtol=1e-4,
                                               atol=1e-4)
                if b == 200:
                    for j in (0, 63, 128, 199):
                        one_c, one_t = alone(j, k)
                        assert torch.equal(one_c, kc[j]) and \
                            torch.equal(one_t, kt[j]), (n, j, k)


@pytest.mark.cuda
def test_launch_counts_lose_nothing_across_threads():
    """Eight threads probing at once (as a serve loop's flusher, planners
    and an index rebuild do): every launch is counted, by entry point and
    by scan, and each thread's answers are bitwise a lone thread's."""
    import threading

    from repro_torch.kernels.cosine_topk import kernel

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernel has no CPU mode")
    store, preds, thr = _case(4096, 256, 12, 1, seed=7)
    args = [torch.from_numpy(a).cuda() for a in (store, preds, thr)]
    want = {b: ops.cosine_probe_batch(args[0], args[1][:b], args[2][:b],
                                      k=4) for b in (3, 12)}
    torch.cuda.synchronize()
    before = (kernel.launches, dict(kernel.entry_launches),
              dict(kernel.path_launches))
    bad = []

    def worker(i):
        b = 3 if i % 2 else 12
        for _ in range(25):
            c, t = ops.cosine_probe_batch(args[0], args[1][:b], args[2][:b],
                                          k=4)
            if not (torch.equal(c, want[b][0]) and torch.equal(t, want[b][1])):
                bad.append(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not bad
    assert kernel.launches - before[0] == 200
    assert (kernel.entry_launches["cosine_probe_batch"]
            - before[1].get("cosine_probe_batch", 0)) == 200
    assert kernel.path_launches["wide"] - before[2]["wide"] == 100
    assert kernel.path_launches["narrow"] - before[2]["narrow"] == 100


MERGE_EDGE = """
import json, torch
from repro_torch.kernels.cosine_topk import ops, ref
torch.manual_seed(0)
x = torch.randn(8192, 256, device="cuda")
x /= x.norm(dim=1, keepdim=True)
p, thr = x[:3].contiguous(), torch.full((3, 2), 0.5, device="cuda")
out = []
for k in (1025, 2055):      # 256 partial blocks x 32: 48 KB of merge keys
    c, t = ops.cosine_probe_batch(x, p, thr, k=k)
    pc, pt = ref.cosine_probe_batch_ref(x, p, thr, k)
    out.append([bool(torch.equal(c, pc)),
                float((t - pt).abs().max())])
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_merge_at_the_shared_memory_edge_in_a_fresh_process():
    """A merge whose keys take exactly 48 KB of dynamic shared memory, as
    the first launch of a process: the merge kernel's static shared memory
    puts that past its default limit, so the launcher must raise the limit
    before the first launch that takes any (a sharded probe at k past a
    shard's rows found this: cudaErrorInvalidValue)."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the probe kernel has no CPU mode")
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    r = subprocess.run([sys.executable, "-c", MERGE_EDGE],
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=str(src)))
    assert r.returncode == 0, r.stderr[-2000:]
    for counts_equal, err in json.loads(r.stdout.strip().splitlines()[-1]):
        assert counts_equal and err <= 1e-4
