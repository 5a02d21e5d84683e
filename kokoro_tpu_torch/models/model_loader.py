"""Load a trained model from a run directory (the programmatic path beside
``KokoroTTS``).

Port of ``kokoro_tpu/models/model_loader.py``: ``ModelLoader(run_dir).load()``
returns ``(KokoroModel, state_dict)``, the model rebuilt from the
checkpoint's metadata (no stochastic depth) with the weights loaded, in eval
mode on the CPU.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from kokoro_tpu_torch.config import KokoroConfig
from kokoro_tpu_torch.models.kokoro import KokoroModel
from kokoro_tpu_torch.training.checkpoint import load_inference_weights

logger = logging.getLogger(__name__)


class ModelLoader:
    """Load a ``KokoroModel`` and its weights from a training output directory."""

    def __init__(self, model_dir: str | Path):
        self.model_dir = Path(model_dir)

    def load(self, checkpoint: Optional[str] = None, use_ema: bool = True
             ) -> Tuple[KokoroModel, Dict[str, torch.Tensor]]:
        """``(model, state_dict)``.  ``checkpoint``: a checkpoint name under
        the run directory or a path; None finds final > best > latest.  The
        EMA weights when ``use_ema`` and the checkpoint recorded EMA updates,
        else the raw ones."""
        path = None
        if checkpoint:
            path = self.model_dir / checkpoint
            if not path.exists():
                path = Path(checkpoint)
            if not path.exists():
                raise FileNotFoundError(f"No checkpoint {checkpoint} under {self.model_dir}")
        state, meta = load_inference_weights(self.model_dir, "auto" if use_ema else "model",
                                             checkpoint=path)
        model = KokoroModel(KokoroConfig.from_metadata(meta, use_stochastic_depth=False))
        model.load_state_dict(state)
        return model.eval(), state
