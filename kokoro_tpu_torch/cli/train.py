"""kokoro-train of the PyTorch port: train the acoustic model on one GPU.

    python -m kokoro_tpu_torch.cli.train --data-dir <corpus> --output-dir <run> --device cuda

``<corpus>`` holds ``metadata.csv`` (``stem|text`` lines) and ``wavs/``;
``<run>`` receives the checkpoints, the logs and the final model, which
``python -m kokoro_tpu_torch.cli.serve --model <run>`` serves.  Port of
``kokoro_tpu/cli/train.py``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="kokoro-train-torch",
        description="Train the Kokoro Russian TTS acoustic model on one GPU")
    from kokoro_tpu_torch.cli.args import add_training_arguments, create_config_from_args

    add_training_arguments(parser)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    model_config, config = create_config_from_args(args)
    if not Path(config.data_dir).exists():
        parser.error(f"data directory not found: {config.data_dir}")
    if config.precompute_features:
        from kokoro_tpu_torch.cli.precompute import precompute_features

        precompute_features(model_config, config, device=args.device)
    from kokoro_tpu_torch.training.trainer import train_model

    result = train_model(model_config, config, device=args.device)
    logging.getLogger(__name__).info("Training done: best val mel %.4f @ epoch %d",
                                     result["best_val_loss"], result["best_val_epoch"] + 1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
