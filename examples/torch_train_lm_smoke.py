"""Train a reduced LM end to end on the PyTorch port, with the whole
training substrate (data pipeline -> train step -> watchdog -> async
checkpoints): ``examples/train_lm_smoke.py`` through ``repro_torch``.

    PYTHONPATH=src python examples/torch_train_lm_smoke.py [--arch jamba-v0.1-52b] [--device cpu]

Every assigned arch id works (reduced configs); the loss must decrease.
"""

import argparse
import tempfile

from repro_torch.launch import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as ckpt:
        train.main(["--arch", args.arch, "--steps", str(args.steps),
                    "--batch", "8", "--seq", "64", "--ckpt-every", "10",
                    "--ckpt-dir", ckpt, "--device", args.device])


if __name__ == "__main__":
    main()
