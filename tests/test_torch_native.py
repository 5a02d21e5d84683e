"""The port's C++ duration aligner (csrc/aligner.cpp through
kokoro_tpu_torch/native) against its own Python DP, the reference semantics:
exactly equal durations on 200 seeded cases, frames conserved, the library
built into kokoro_tpu_torch/build/ and nowhere in the package tree, and the
Python fallback, with a warning, when the library cannot be built.

Imports numpy and the port only (no JAX), so it also runs on the machine with
the card:  python -m pytest tests/test_torch_native.py -q
(``tests/test_torch_mfa.py`` holds both against the JAX package.)
"""

import logging
from pathlib import Path

import numpy as np
import pytest

from kokoro_tpu_torch import native
from kokoro_tpu_torch.data import mfa
from kokoro_tpu_torch.native import binding

ROOT = Path(__file__).resolve().parents[1]
PHONES = ["p", "a", "t", "k", "o", "nʲ", "ʃ", "ts", "i", "rʲ", "u", "m", "e", "ɪ", "ə", "l"]


def random_case(rng: np.random.Generator):
    """A correlated (MFA phones with frames, G2P phones) pair exercising every
    op of the DP: matches, MFA-only and text-only phones, ``<sil>`` and
    prosody tokens, iotation, geminates, ``spn`` spans and empty sides."""
    if rng.random() < 0.05:
        return [], [str(p) for p in rng.choice(PHONES, int(rng.integers(0, 4)))]
    if rng.random() < 0.05:
        return [(str(rng.choice(PHONES)), int(rng.integers(1, 9)))], []
    mfa_side, text = [], []
    for _ in range(int(rng.integers(1, 40))):
        u, ph = rng.random(), str(rng.choice(PHONES))
        if u < 0.5:
            text.append(ph)
            mfa_side.append((ph, int(rng.integers(0, 20))))
        elif u < 0.6:
            text.append(str(rng.choice([ph, "<sil>", "<period>", "<comma>", "<question>"])))
        elif u < 0.7:
            mfa_side.append((str(rng.choice([ph, "<sil>"])), int(rng.integers(1, 10))))
        elif u < 0.8:
            jv = str(rng.choice(sorted(mfa.IOTATED)))
            text.append(jv)
            mfa_side += [("j", int(rng.integers(1, 4))), (mfa.IOTATED[jv], int(rng.integers(1, 8)))]
        elif u < 0.9:
            text += [ph, ph]
            mfa_side.append((ph + "ː", int(rng.integers(2, 12))))
        else:
            k = int(rng.integers(1, 5))
            text += [str(p) for p in rng.choice(PHONES, k)]
            mfa_side.append(("spn", int(rng.integers(k, 30))))
    return mfa_side, text


@pytest.mark.parametrize("chunk", range(4))
def test_native_equals_python_dp(chunk):
    rng = np.random.default_rng(chunk)
    calls, both_sides = binding.calls, 0
    for _ in range(50):
        mfa_side, text = random_case(rng)
        python = mfa.align_durations(mfa_side, text, use_native=False)
        assert mfa.align_durations(mfa_side, text) == python, (mfa_side, text)
        if text:
            assert len(python) == len(text) and sum(python) == sum(f for _, f in mfa_side)
        both_sides += bool(mfa_side and text)
    assert binding.calls == calls + both_sides  # the native DP ran every such case


def test_library_builds_into_the_build_directory():
    assert native.native_available()
    path = native.library_path()
    assert path.parent == ROOT / "kokoro_tpu_torch" / "build" and path.is_file()
    assert path.name.startswith("libaligner-")
    for where in ("native", "csrc"):
        assert not list((ROOT / "kokoro_tpu_torch" / where).glob("*.so")), where


def test_python_fallback_when_the_build_fails(tmp_path, monkeypatch, caplog):
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_build_failed", False)
    monkeypatch.setattr(binding, "library_path", lambda: tmp_path / "libaligner-x.so")
    monkeypatch.setattr(binding, "CXX", str(tmp_path / "no-such-compiler"))
    case = ([("p", 3), ("spn", 9), ("a", 4)], ["p", "t", "k", "a"])
    with caplog.at_level(logging.WARNING):
        assert not native.native_available()
        assert mfa.align_durations(*case) == mfa.align_durations(*case, use_native=False)
    assert any("build failed" in r.getMessage() for r in caplog.records)
    assert not list(tmp_path.iterdir())
