"""Build and load the port's CUDA sources.

On first use a kernel's ``csrc/*.cu`` files are compiled with ``nvcc``
into a shared library with a plain C interface, under ``build/kernels/``
at the root of the checkout, named by a hash of the sources and flags, so
an edited source rebuilds and an unchanged one loads the cached library.
The library is bound with ``ctypes``.  Nothing here runs at import time,
and a missing ``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

#: build outputs, at the root of the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``CUDA_HOME`` (default
    ``/usr/local/cuda``).  Raises when there is none."""
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "compiled on first use and need the CUDA toolkit")


def library_path(name: str, sources: list[Path]) -> Path:
    """Where the library built from ``sources`` lives (content-keyed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, sources: list[Path]) -> Path:
    """Compile ``sources`` into ``lib<name>`` unless a library of the same
    content exists; returns its path.  The compiler's report (registers,
    shared memory, spills) is kept beside it as ``.log``."""
    out = library_path(name, sources)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}) building {name}:"
                           f"\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def load(name: str, csrc: Path) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/*.cu``."""
    sources = sorted(csrc.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {csrc}")
    return ctypes.CDLL(str(build(name, sources)))
