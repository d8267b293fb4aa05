#!/usr/bin/env python3
"""Time one attention kernel of a port tree, for comparing two trees.

``decode`` (the default): the flash-decode wrapper at the KV-batch main
path's shape (B 23, L 1168, valid 1153..1158, Hkv 8, rep 4, D 128, bf16;
20 passes of the six prompt steps by CUDA events, per step, five
readings), and the registers and spills of its bf16 D = 128 mma
instance. ``flash``: the flash forward at the serve shape (B 23, S 2880,
32 / 8 heads, D 128, bf16, causal) and at smollm-360m's training shape
with the lse output (B 4, S 4096, 15 / 5 heads, D 64), five readings of
20 calls each, and the registers and spills of its wgmma instances at
D 128 and 64. ``bwd``: the flash backward at smollm-360m's training shape
and at D 128 (B 2, S 4096, 32 / 8 heads; causal, bf16), five readings
of 20 calls each, and the registers and spills of its kernels at D 64.
Registers are printed when this process built the library.

    python3 scripts/torch_decode_ab.py SRC [decode|flash|bwd]
    # SRC: a tree's src/

Comparing two trees on one card: unpack the parent's ``src/`` with
``git archive`` into a directory ``.gitignore`` lists and run parent,
change, change, parent in one command.
"""

import re
import sys

sys.path.insert(0, sys.argv[1])

import torch  # noqa: E402

from repro_torch.kernels import _build  # noqa: E402

LIBRARY = {"decode": "decode_attention", "flash": "flash_attention",
           "bwd": "flash_attention_bwd"}
# the instances whose ptxas lines are printed, by their mangled names
INSTANCES = {"decode": ["decode_split_mmaILi128"],
             "flash": ["flash_fwd_wgmmaILi128E", "flash_fwd_wgmmaILi64E"],
             "bwd": [r"bwd_\w+ILi64E"]}


def ms(fn, iters=20) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def registers(src: str, what: str) -> None:
    _build.build_all([LIBRARY[what]])
    log = _build.build_log.get(LIBRARY[what], "")
    for block in log.split("Function properties for ")[1:]:
        name = block.split()[0]
        if any(re.search(p, name) for p in INSTANCES[what]):
            print(src, name + ":",
                  re.findall(r"Used \d+ registers", block)[:1],
                  re.findall(r"\d+ bytes spill stores", block)[:1])


def decode(src, rn) -> None:
    from repro_torch.kernels.decode_attention import ops as da

    qd, kc, vc = rn(23, 1, 32, 128), rn(23, 1168, 8, 128), rn(23, 1168, 8, 128)
    valids = [1153 + i for i in range(6)]

    def fn():
        return [da.decode_attention(qd, kc, vc, kv_valid=n) for n in valids]

    print(src, "decode main shape ms",
          [round(ms(fn) / 6, 5) for _ in range(5)], flush=True)


def flash(src, rn) -> None:
    from repro_torch.kernels.flash_attention import kernel

    for label, (B, S, H, hkv, D), lse in (
            ("serve", (23, 2880, 32, 8, 128), False),
            ("train lse", (4, 4096, 15, 5, 64), True)):
        q, k, v = rn(B, S, H, D), rn(B, S, hkv, D), rn(B, S, hkv, D)
        times = [ms(lambda: kernel.flash_fwd(
            q, k, v, causal=True, window=None, scale=D ** -0.5,
            return_lse=lse)) for _ in range(5)]
        print(src, label, f"B={B} S={S} H={H} Hkv={hkv} D={D}:",
              [round(t, 4) for t in times], "ms", flush=True)


def bwd(src, rn) -> None:
    from repro_torch.kernels.flash_attention import backward, kernel

    for B, S, H, hkv, D in ((4, 4096, 15, 5, 64), (2, 4096, 32, 8, 128)):
        q, k, v, dout = (rn(B, S, h, D) for h in (H, hkv, hkv, H))
        out, lse = kernel.flash_fwd(q, k, v, causal=True, window=None,
                                    scale=D ** -0.5, return_lse=True)
        times = [ms(lambda: backward.flash_bwd(
            q, k, v, out, lse, dout, causal=True, window=None,
            scale=D ** -0.5)) for _ in range(5)]
        print(src, f"backward B={B} S={S} H={H} Hkv={hkv} D={D}:",
              [round(t, 4) for t in times], "ms", flush=True)


def main() -> None:
    src = sys.argv[1]
    what = sys.argv[2] if len(sys.argv) > 2 else "decode"
    if what not in LIBRARY:
        sys.exit(f"kernel {what!r}: one of {sorted(LIBRARY)}")
    registers(src, what)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    {"decode": decode, "flash": flash, "bwd": bwd}[what](src, rn)


if __name__ == "__main__":
    main()
