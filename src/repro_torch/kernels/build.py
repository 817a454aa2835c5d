"""Build the CUDA sources under ``csrc/`` into shared libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/<name>-<digest>.so`` at the repository root (a
git-ignored directory), where ``<digest>`` hashes the source and the
flags, so an edited source builds anew and an unchanged one is reused.
The libraries expose plain C entry points and are loaded with
``ctypes``; nothing here includes PyTorch's headers, so a build takes
seconds.  Nothing is compiled when this module is imported: the first
:func:`load` (or :func:`build`) does it, with one ``nvcc`` per missing
library, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: on PATH, else under CUDA_HOME or the
    toolkit's standard prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def sources(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """name -> source path, for ``names`` (default: every source)."""
    found = {p.stem: p for p in sorted(CSRC.glob("*.cu"))}
    if names is None:
        return found
    missing = [n for n in names if n not in found]
    if missing:
        raise KeyError(f"no CUDA source for {missing} under {CSRC}")
    return {n: found[n] for n in names}


def library_path(src: Path) -> Path:
    digest = hashlib.sha1(src.read_bytes()
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every requested source whose library is missing, one
    ``nvcc`` process per source, all running at once.  The compiler's
    output (with ``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``.log``.  Returns name -> library."""
    srcs = sources(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name, src in srcs.items():
        lib = library_path(src)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = lib.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=fh, stderr=subprocess.STDOUT)
        running.append((name, proc, tmp, lib, log))
    failed = []
    for name, proc, tmp, lib, log in running:
        if proc.wait() == 0:
            os.replace(tmp, lib)     # atomic: a reader never sees half a file
        else:
            failed.append(f"{name}:\n{log.read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(src) for name, src in srcs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib
