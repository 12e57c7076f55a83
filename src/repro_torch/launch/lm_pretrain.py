"""LM pretraining through the port's training launcher — checkpointing,
journal, straggler watchdog, resume; port of ``examples/lm_pretrain.py``,
which forwards the reference's defaults to
:func:`repro_torch.launch.train.main` (a reduced config, a checkpoint
every 10 steps).

    PYTHONPATH=src python -m repro_torch.launch.lm_pretrain --steps 40
    # stop it mid-run, then:
    PYTHONPATH=src python -m repro_torch.launch.lm_pretrain --steps 40 --resume

The checkpoints go to ``--ckpt-dir`` (default: ``repro_torch_lm_pretrain``
in the temporary directory). It runs on the card unless ``--device cpu``
is given; without a card it raises.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_pretrain"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    a = ap.parse_args(argv)
    args = ["--arch", a.arch, "--reduced", "--steps", str(a.steps),
            "--batch", str(a.batch), "--seq", str(a.seq),
            "--ckpt-dir", a.ckpt_dir, "--ckpt-every", "10"]
    if a.resume:
        args.append("--resume")
    if a.device is not None:
        args += ["--device", a.device]
    return {"arch": a.arch, "losses": train_main(args)}


if __name__ == "__main__":
    main()
