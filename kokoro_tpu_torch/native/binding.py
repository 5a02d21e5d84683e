"""ctypes binding for the C++ duration aligner (``csrc/aligner.cpp``).

Port of ``kokoro_tpu/native/binding.py``.  The library builds at first use
with ``g++ -O3 -shared -fPIC`` into ``kokoro_tpu_torch/build/`` (listed in
``.gitignore``), named after the hash of its source like the kernel
libraries (``ops/kernels.py``), so an edited source builds anew.  ``calls``
counts the alignments the native DP ran, so a caller can tell it was used.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from kokoro_tpu_torch.ops.kernels import BUILD_DIR, CSRC_DIR

logger = logging.getLogger(__name__)

SOURCE = CSRC_DIR / "aligner.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
calls = 0  # alignments run by the native DP


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libaligner-{digest.hexdigest()[:12]}.so"


def _ensure_built() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                               check=True, capture_output=True, timeout=120)
                os.replace(tmp, path)
                logger.info("Built native aligner: %s", path)
            except (subprocess.SubprocessError, OSError) as err:
                logger.warning("Native aligner build failed (%s); using Python DP", err)
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as err:
            logger.warning("Cannot load native aligner: %s", err)
            _build_failed = True
            return None
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.align_durations_dp.restype = ctypes.c_int
        lib.align_durations_dp.argtypes = [ctypes.c_int32, ctypes.c_int32, i32,
                                           u8, u8, u8, u8, u8, i32]
        _lib = lib
        return lib


def native_available() -> bool:
    return _ensure_built() is not None


def native_align_durations(
    mfa_labeled: List[Tuple[str, int]],
    text_phones: List[str],
    *,
    phones_equivalent,
    iotated: Dict[str, str],
    prosody_tokens,
    length_mark: str,
) -> Optional[List[int]]:
    """Run the C++ DP.  Returns None when no path exists or the library is
    unavailable.

    The equivalence, iotation and geminate relations are precomputed here as
    ``(n, m)`` matrices (``eq``, ``iot``, ``gem``), with the ``spn`` flags of
    the MFA phones and the ``kind`` of each text phone (0 phone, 1 ``<sil>``,
    2 prosody), so the C++ DP is string-free.  The strings become integer
    ids first and each matrix one numpy comparison (``phones_equivalent`` is
    called once per distinct pair of labels): a loop over the n x m cells in
    Python took most of an utterance's alignment time."""
    global calls
    lib = _ensure_built()
    if lib is None:
        return None
    n, m = len(mfa_labeled), len(text_phones)
    if m == 0:
        return []
    if n == 0:
        return [0] * m

    mfa_phones = [p for p, _ in mfa_labeled]
    frames = np.asarray([f for _, f in mfa_labeled], np.int32)
    spn = np.asarray([p == "spn" for p in mfa_phones], np.uint8)
    kind = np.asarray(
        [2 if t in prosody_tokens else 1 if t == "<sil>" else 0 for t in text_phones], np.uint8)

    ids: Dict[str, int] = {}

    def id_of(labels) -> np.ndarray:  # -1 for None
        return np.asarray([-1 if x is None else ids.setdefault(x, len(ids)) for x in labels])

    mfa_id, text_id = id_of(mfa_phones), id_of(text_phones)
    # eq: phones_equivalent over the distinct (MFA label, text phone) pairs
    labels, texts = sorted(set(mfa_phones)), sorted(set(text_phones))
    table = np.asarray([[phones_equivalent(p, t) for t in texts] for p in labels], np.uint8)
    row = {ids[p]: k for k, p in enumerate(labels)}
    col = {ids[t]: k for k, t in enumerate(texts)}
    eq = table[np.asarray([row[i] for i in mfa_id])[:, None],
               np.asarray([col[j] for j in text_id])[None, :]]
    # iot: MFA "j" then the vowel that the iotated text phone stands for
    next_id = np.append(mfa_id[1:], -2)
    vowel_id = id_of([iotated.get(t) for t in text_phones])
    iot = ((np.asarray(mfa_phones) == "j") & (next_id >= 0))[:, None] & (
        (next_id[:, None] == vowel_id[None, :]) & (vowel_id >= 0)[None, :])
    # gem: a geminate Xː over two equal text phones X X
    is_gem = np.asarray([length_mark in p for p in mfa_phones])
    base_id = id_of([p.replace(length_mark, "") for p in mfa_phones])
    next_text_id = np.append(text_id[1:], -2)
    gem = is_gem[:, None] & (base_id[:, None] == text_id[None, :]) & (
        base_id[:, None] == next_text_id[None, :])
    eq, iot, gem = (np.ascontiguousarray(x, np.uint8) for x in (eq, iot, gem))

    durations = np.zeros(m, np.int32)
    rc = lib.align_durations_dp(n, m, frames, eq.reshape(-1), iot.reshape(-1),
                                gem.reshape(-1), spn, kind, durations)
    calls += 1
    if rc != 0:
        return None
    return durations.tolist()
