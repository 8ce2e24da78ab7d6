"""Build and load the port's CUDA sources.

On first use a kernel's ``csrc/*.cu`` files are compiled with ``nvcc``
into a shared library with a plain C interface, under ``build/kernels/``
at the root of the checkout, named by a hash of the sources, the shared
headers (``kernels/include/*.cuh``, on the include path) and the flags,
so an edited source or header rebuilds and an unchanged one loads the
cached library.
The library is bound with ``ctypes``.  Nothing here runs at import time,
and a missing ``nvcc`` or a failed compile raises.  ``require_cuda`` and
``launch`` are the launchers' shared checks and stream plumbing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

#: build outputs, at the root of the checkout (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: headers the kernels' sources share
INCLUDE_DIR = Path(__file__).resolve().parent / "kernels" / "include"


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
    """Where the library built from ``sources`` lives (keyed by their
    content and the shared headers')."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [*sources, *sorted(INCLUDE_DIR.glob("*.cuh"))]:
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
    cmd = [find_nvcc(), *NVCC_FLAGS, f"-I{INCLUDE_DIR}", "-o", str(tmp),
           *map(str, sources)]
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


def require_cuda(dev: torch.device, what: str) -> None:
    """Raise unless ``dev`` is a CUDA device (a launcher's input check)."""
    if dev.type != "cuda":
        raise ValueError(f"{what} launches on CUDA tensors, not {dev}")


def launch(fn, dev: torch.device, *args) -> int:
    """Call the C launcher ``fn`` with ``args`` and PyTorch's current
    stream on ``dev`` (as a pointer); returns its CUDA error code."""
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
