"""CLI entry point of training.

    python -m sdxl_training_improvements_tpu_torch.main --config <yaml>
        [--output-dir DIR] [--resume [DIR]] [--max-steps N] [--method M]
        [--device cuda|cpu]

Port of ``sdxl_training_improvements_tpu/main.py``: the same flags, plus
``--device`` (the card unless told otherwise).  ``Config.from_yaml`` ->
``SDXLTrainer`` -> ``prepare_data`` -> ``train``; checkpoints go into
``--output-dir``, and ``--resume`` (no directory: the latest checkpoint
there) continues a run.
"""
from __future__ import annotations

import argparse
import sys

from sdxl_training_improvements_tpu_torch.config import Config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sdxl-torch-train",
        description="SDXL fine-tuning on PyTorch (ddpm / flow_matching)")
    p.add_argument("--config", default="config.yaml",
                   help="YAML config path (reference schema)")
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--resume", nargs="?", const="auto", default=None,
                   help="checkpoint dir to resume from; bare flag = latest")
    p.add_argument("--max-steps", type=int, default=None,
                   help="hard step cap (overrides epochs)")
    p.add_argument("--method", default=None,
                   help="override training.method (ddpm | flow_matching)")
    p.add_argument("--device", default="cuda",
                   help="torch device (the card unless told otherwise)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    config = Config.from_yaml(args.config)
    if args.resume is not None:
        config.training.resume_from = args.resume
    if args.max_steps is not None:
        config.training.max_steps = args.max_steps
    if args.method is not None:
        config.training.method = args.method

    from sdxl_training_improvements_tpu_torch.core.logging import (
        cleanup_logging)
    from sdxl_training_improvements_tpu_torch.training.loop import (
        SDXLTrainer)

    try:
        trainer = SDXLTrainer(config, output_dir=args.output_dir,
                              device=args.device)
        trainer.prepare_data()
        trainer.train()
    finally:
        # close the log file: a second run in this process logs where its
        # own config says
        cleanup_logging()
    return 0


def cli() -> None:
    sys.exit(main())


if __name__ == "__main__":
    cli()
