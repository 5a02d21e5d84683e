"""Device info, parameter counting and training-time estimation.

Port of ``kokoro_tpu/utils/misc.py`` on ``torch.cuda``.
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Union

import torch

logger = logging.getLogger(__name__)


def device_info() -> Dict:
    """The visible CUDA devices: backend, count, names and total memory."""
    if not torch.cuda.is_available():
        return {"backend": "cpu", "device_count": 0, "devices": [], "total_memory_bytes": [],
                "process_count": 1}
    n = torch.cuda.device_count()
    props = [torch.cuda.get_device_properties(i) for i in range(n)]
    return {"backend": "cuda", "device_count": n, "devices": [p.name for p in props],
            "total_memory_bytes": [p.total_memory for p in props], "process_count": 1}


def log_device_info() -> None:
    info = device_info()
    logger.info("torch backend %s: %d device(s) — %s", info["backend"], info["device_count"],
                ", ".join(f"{name} ({mem / 1024**3:.1f} GiB)" for name, mem in
                          zip(info["devices"][:8], info["total_memory_bytes"])))


def count_parameters(params: Union[torch.nn.Module, Mapping[str, torch.Tensor]]) -> int:
    """Elements of a module's parameters, or of a state dict's tensors."""
    tensors = params.parameters() if isinstance(params, torch.nn.Module) else params.values()
    return sum(t.numel() for t in tensors)


def format_model_size(n_params: int) -> str:
    """Human-readable parameter count."""
    if n_params >= 1e9:
        return f"{n_params / 1e9:.2f}B"
    if n_params >= 1e6:
        return f"{n_params / 1e6:.2f}M"
    if n_params >= 1e3:
        return f"{n_params / 1e3:.1f}K"
    return str(n_params)


def estimate_training_time(steps_per_epoch: int, num_epochs: int,
                           measured_step_s: float) -> Dict[str, float]:
    """Wall-clock estimate from a measured step time."""
    total_steps = steps_per_epoch * num_epochs
    return {
        "total_steps": total_steps,
        "total_hours": total_steps * measured_step_s / 3600.0,
        "per_epoch_minutes": steps_per_epoch * measured_step_s / 60.0,
    }
