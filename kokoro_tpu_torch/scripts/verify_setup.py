"""Environment check of the port: its runtime packages, the CUDA devices,
the compilers its kernels and its aligner build with at first use, MFA, and
optionally a corpus.

Port of ``scripts/verify_setup.py``.  The reference checks JAX's packages
and devices; the port checks torch, numpy and scipy, ``torch.cuda``'s
devices (name, compute capability), ``nvcc`` (as ``ops/kernels.py`` finds
it: ``$CUDA_HOME/bin`` or ``PATH``) and the host C++ compiler of
``native/binding.py``, MFA through ``data/mfa.MFAIntegration`` (optional:
estimated durations are the fallback) and a corpus through
``cli/preprocess.validate_corpus``.  A machine without CUDA, or without
``nvcc`` or the C++ compiler, FAILs: the port's entry points run on the
card.

    python -m kokoro_tpu_torch.scripts.verify_setup [--corpus DIR]

Prints ``RESULT: PASS`` and exits 0, or ``RESULT: FAIL`` and exits 1.
"""

from __future__ import annotations

import argparse
import importlib
import shutil


def check_dependencies() -> list:
    results = []
    for mod in ("torch", "numpy", "scipy"):
        try:
            m = importlib.import_module(mod)
            results.append((mod, True, getattr(m, "__version__", "?")))
        except ImportError as err:
            results.append((mod, False, str(err)))
    return results


def check_devices() -> dict:
    """``torch.cuda``'s view: whether CUDA is there, the CUDA version torch
    was built for, and each device's name and compute capability."""
    import torch

    available = torch.cuda.is_available()
    count = torch.cuda.device_count() if available else 0
    return {
        "cuda_available": available,
        "torch_cuda": torch.version.cuda,
        "devices": [f"{torch.cuda.get_device_name(i)} "
                    f"(sm_{''.join(map(str, torch.cuda.get_device_capability(i)))})"
                    for i in range(count)],
        "count": count,
    }


def check_compilers() -> dict:
    """The paths of ``nvcc`` (the attention kernels) and the host C++
    compiler (the duration aligner), or None."""
    from kokoro_tpu_torch.native.binding import CXX
    from kokoro_tpu_torch.ops.kernels import nvcc_path

    try:
        nvcc = nvcc_path()
    except RuntimeError:
        nvcc = None
    return {"nvcc": nvcc, CXX: shutil.which(CXX)}


def check_mfa() -> dict:
    from kokoro_tpu_torch.data.mfa import MFAIntegration

    mfa = MFAIntegration()
    return {"binary": mfa.mfa_binary, "available": mfa.available}


def check_corpus(corpus_dir: str) -> dict:
    from kokoro_tpu_torch.cli.preprocess import validate_corpus

    return validate_corpus(corpus_dir)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--corpus", default=None)
    args = parser.parse_args(argv)

    ok = True
    print("Dependencies:")
    for mod, found, info in check_dependencies():
        print(f"  [{'OK' if found else 'MISSING'}] {mod} {info}")
        ok &= found
    if not ok:
        print("RESULT: FAIL")
        return 1
    devices = check_devices()
    print("Devices:", devices)
    if not devices["count"]:
        print("  [MISSING] CUDA: no CUDA device (the port's entry points run on the card)")
        ok = False
    for name, path in check_compilers().items():
        print(f"  [{'OK' if path else 'MISSING'}] {name} {path or 'not found'}")
        ok &= path is not None
    mfa = check_mfa()
    print(f"MFA: {'OK ' + str(mfa['binary']) if mfa['available'] else 'not found (estimated durations will be used)'}")
    if args.corpus:
        report = check_corpus(args.corpus)
        print("Corpus:", report)
        ok &= report["valid"]
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
