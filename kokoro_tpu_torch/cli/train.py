"""kokoro-train of the PyTorch port: train the acoustic model.

    python -m kokoro_tpu_torch.cli.train --data-dir <corpus> --output-dir <run> --device cuda
    python -m torch.distributed.run --nproc-per-node N -m kokoro_tpu_torch.cli.train \
        --distributed --mesh-shape 2,2 --mesh-axes data,model --data-dir <corpus> ...

(the second on N GPUs, one process each: ``--mesh-shape`` names the layout,
its product N, over the axes ``--mesh-axes`` names: ``data,model``,
``data,seq``, ``data,seq,model`` or ``data,stage``; ``--dist-backend gloo
--device cuda:0`` puts every process on one card).

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
        description="Train the Kokoro Russian TTS acoustic model")
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
    if args.profile_dtypes and config.distributed_init:
        parser.error("--profile-dtypes times one process; run it without --distributed and "
                     "pass its choice as --compute-dtype")
    if args.profile_dtypes:
        # the reference's pre-train bf16/f32 A/B (kokoro_tpu/cli/train.py)
        from kokoro_tpu_torch.utils.profiling import profile_dtype_for_config

        config.compute_dtype = profile_dtype_for_config(model_config, config, device=args.device)
        logging.getLogger(__name__).info("dtype profile selected compute_dtype=%s",
                                         config.compute_dtype)
    import torch.distributed as dist

    from kokoro_tpu_torch.training.trainer import train_model

    device = args.device
    if args.dist_backend and config.distributed_init:
        from kokoro_tpu_torch.parallel.mesh import init_distributed

        device = init_distributed(device=device, backend=args.dist_backend)
    try:
        result = train_model(model_config, config, device=device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    logging.getLogger(__name__).info("Training done: best val mel %.4f @ epoch %d",
                                     result["best_val_loss"], result["best_val_epoch"] + 1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
