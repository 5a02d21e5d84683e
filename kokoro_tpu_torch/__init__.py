"""kokoro_tpu_torch — the PyTorch/CUDA port of ``kokoro_tpu`` for one NVIDIA
H100 (Hopper, sm_90a).

Each module mirrors its counterpart under the same path in ``kokoro_tpu/``,
which stays in the repository as the reference the port is tested against.
The port imports ``torch``, numpy and the standard library only, never JAX
or any module of ``kokoro_tpu``.  Every Pallas kernel of the JAX package on a
ported path becomes a hand-written Hopper kernel under ``csrc/``, beside a
plain PyTorch version of the same function.
"""

from kokoro_tpu_torch.version import __version__

__all__ = ["__version__"]
