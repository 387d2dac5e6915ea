"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/kernels/<name>-<hash>.so`` at the repository root (listed in
``.gitignore``).  The hash covers the source, every ``csrc/*.cuh`` header
and the flags, so an edited kernel rebuilds and an unchanged one loads at
once.  ``build()`` starts one nvcc per source, all together, and waits for
all of them, and keeps nvcc's report (``-Xptxas=-v``: registers, spills)
beside each library, where ``report`` reads it.  The first call to
``library`` builds, so a fresh checkout builds everything the first time a
kernel launches.

A failed build raises with nvcc's stderr.  Nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin: "
                           "the port's CUDA kernels cannot be built")
    return path


def target(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, str]:
    """Compile every source whose library is missing, one nvcc each, all
    started together.  Returns nvcc's report (registers, shared memory and
    spills from ``-Xptxas=-v``) for each source compiled by this call."""
    todo = [(src, target(src)) for src in sources()
            if not target(src).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, out in todo:
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports, failures = {}, []
    for src, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {src.name} (exit "
                            f"{proc.returncode}):\n{stderr}{stdout}")
        else:
            out.with_suffix(".txt").write_text(stderr + stdout)
            os.replace(tmp, out)
            reports[src.stem] = stderr + stdout
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def report(name: str) -> str:
    """nvcc's report for ``csrc/<name>.cu``, built first if need be."""
    build()
    return target(CSRC / f"{name}.cu").with_suffix(".txt").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _libs:
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(src)
        build()
        _libs[name] = ctypes.CDLL(str(target(src)))
    return _libs[name]
