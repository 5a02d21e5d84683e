"""Native (C++) host code, bound via ctypes.

* ``csrc/aligner.cpp``: the Needleman-Wunsch duration-alignment DP of
  ``kokoro_tpu_torch.data.mfa``; the Python DP there stays the reference and
  the fallback.

A library builds with ``g++`` at first use into ``kokoro_tpu_torch/build/``,
named after the hash of its source, never into the package tree.
"""

from kokoro_tpu_torch.native.binding import (
    library_path, native_align_durations, native_available,
)

__all__ = ["library_path", "native_align_durations", "native_available"]
