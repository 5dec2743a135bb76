"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use, with ``nvcc`` for ``sm_90a`` (Hopper), into a shared library under
``build/ensem3a_torch_kernels/`` at the root of the checkout, then loaded
with ``ctypes``.  The library's file name carries a hash of its source,
the shared ``csrc/*.cuh`` headers and the flags, so an edited source or
header is rebuilt.  There is no fallback: a
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "ensem3a_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> List[str]:
    """Names of every kernel source in ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
            nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return nvcc


def _target(name: str) -> Path:
    """The library's path; its tag hashes the source, every shared header
    in ``csrc/`` and the flags, so an edited header rebuilds each kernel."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] | None = None) -> Dict[str, str]:
    """Compile the named sources (all by default) that are not built yet,
    one ``nvcc`` per source, all started together.  Returns each source's
    compiler output (``-Xptxas -v``: registers, shared memory, spills),
    kept beside the library for one built earlier; raises if any build
    fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, logs, failed = {}, {}, []
    for name in names:
        out = _target(name)
        if out.exists():
            log = out.with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(logs[name])
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(_target(name)))
        return lib
