"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `lib<name>.so`, compiled for sm_90a into
`<repo>/build/torch_kernels/<name>-<hash>/` (git-ignored) at first use. The
hash covers the sources and the flags, so an edited kernel rebuilds and an
unchanged one loads from disk. A build with preprocessor `defines` (the
CTA clock stamps of `tools/cta_clocks.py`) is a library of its own name,
`lib<name>_<defines>.so`, which the main path never loads. The build
writes to a temporary file and renames it into place, so an interrupted
build never leaves a truncated library behind.

A missing nvcc or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels cannot be built")


def _sources(name: str) -> list[pathlib.Path]:
    main = CSRC / f"{name}.cu"
    if not main.is_file():
        raise FileNotFoundError(main)
    return [main] + sorted(CSRC.glob("*.cuh"))


def _flags(defines: tuple[str, ...]) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: tuple[str, ...] = ()) -> pathlib.Path:
    """Where `lib<name>.so` (with `defines`: `lib<name>_<defines>.so`) lives
    for the current sources and flags."""
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    stem = "_".join((name, *defines)).lower()
    return BUILD_ROOT / f"{stem}-{h.hexdigest()[:16]}" / f"lib{stem}.so"


def build(name: str, defines: tuple[str, ...] = ()) -> pathlib.Path:
    """Compile `csrc/<name>.cu` (with `-D` of each of `defines`) unless the
    library for these sources exists. The compiler's output (ptxas register
    / shared-memory report) is kept in `build.log` beside the library."""
    lib = library_path(name, defines)
    if lib.is_file():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [_nvcc(), *_flags(defines), "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (lib.parent / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build if needed, then load `lib<name>.so` (or its build with
    `defines`) once per process."""
    return ctypes.CDLL(str(build(name, defines)))
