"""Batched LM serving through the port's serve path: prefill a prompt
batch, then decode greedily from the grown cache; port of
``examples/serve_batched.py``, which forwards the reference's defaults
to :func:`repro_torch.launch.serve.main` (a reduced config).

    PYTHONPATH=src python -m repro_torch.launch.serve_batched
        [--arch rwkv6-3b] [--batch 4] [--prompt-len 32] [--gen 16]
        [--device cpu]

It runs on the card unless ``--device cpu`` is given; without a card it
raises.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    args = ["--arch", a.arch, "--reduced", "--batch", str(a.batch),
            "--prompt-len", str(a.prompt_len), "--gen", str(a.gen)]
    if a.device is not None:
        args += ["--device", a.device]
    return {"arch": a.arch, "tokens": serve_main(args)}


if __name__ == "__main__":
    main()
