#!/usr/bin/env python3
"""Time the flash-decode wrapper of a port tree at the KV-batch main
path's shape (B 23, L 1168, valid 1153..1158, Hkv 8, rep 4, D 128, bf16;
20 passes of the six prompt steps by CUDA events, per step, five
readings) and print the registers and spills of its bf16 D = 128 mma
instance when this process built the library.

    python3 scripts/torch_decode_ab.py SRC     # SRC: a tree's src/

Comparing two trees on one card: unpack the parent's ``src/`` with
``git archive`` into a directory ``.gitignore`` lists and run parent,
change, change, parent in one command.
"""

import re
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da  # noqa: E402


def main() -> None:
    src = sys.argv[1]
    _build.build_all(["decode_attention"])
    log = _build.build_log.get("decode_attention", "")
    i = log.find("decode_split_mmaILi128")
    print(src, "mma<128>:", re.findall(r"Used \d+ registers",
                                       log[i:i + 1500])[:1],
          re.findall(r"\d+ bytes spill stores", log[i:i + 1500])[:1])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    B = 23
    qd, kc, vc = rn(B, 1, 32, 128), rn(B, 1168, 8, 128), rn(B, 1168, 8, 128)
    valids = [1153 + i for i in range(6)]

    def per_step_ms():
        def fn():
            return [da.decode_attention(qd, kc, vc, kv_valid=n)
                    for n in valids]
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / 20 / 6

    print(src, "decode main shape ms",
          [round(per_step_ms(), 5) for _ in range(5)], flush=True)


if __name__ == "__main__":
    main()
