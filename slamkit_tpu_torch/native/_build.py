"""Build the package's C++ host libraries with g++ and load them with ctypes.

Each `native/<name>.cpp` becomes `lib<name>.so` in
`<repo>/build/native/<name>-<hash>/` (git-ignored) at first use, with the
flags of `slamkit_tpu/native/bindings.py:31-37` (the audio decoder links the
system's libav). The hash covers the source and the flags, so an edited
source rebuilds and an unchanged one loads from disk. The build writes to a
temporary file and renames it into place, so concurrent builds (several test
workers) and an interrupted one never leave a truncated library behind. A
failed build is remembered for the life of the process, so a loop over a
corpus does not run g++ again for each file; its error is raised each time.
The library never lands beside its source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

HERE = pathlib.Path(__file__).resolve().parent
BUILD_ROOT = HERE.parents[1] / "build" / "native"
FLAGS = ("-O2", "-shared", "-fPIC")
LIBS = {"audio": ("-lavformat", "-lavcodec", "-lavutil", "-lswresample"),
        "codec": (), "pack": ()}


class NativeUnavailable(RuntimeError):
    """A native library could not be built or loaded."""


def library_path(name: str) -> pathlib.Path:
    """Where `lib<name>.so` lives for the current source and flags."""
    h = hashlib.sha256(" ".join(FLAGS + LIBS[name]).encode())
    h.update((HERE / f"{name}.cpp").read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build(name: str) -> pathlib.Path:
    """Compile `native/<name>.cpp` unless its library exists; raises
    NativeUnavailable with g++'s output when it cannot."""
    lib = library_path(name)
    if lib.is_file():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeUnavailable(f"g++ not found on PATH: lib{name}.so cannot be built")
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = [gxx, *FLAGS, str(HERE / f"{name}.cpp"), "-o", tmp, *LIBS[name]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeUnavailable(f"g++ failed ({proc.returncode}) building lib{name}.so: "
                                f"{' '.join(cmd)}\n{proc.stderr.strip()}")
    os.replace(tmp, lib)
    return lib


_LOCK = threading.Lock()
_loaded: dict = {}   # name -> ctypes.CDLL, or the NativeUnavailable of its failed build


def load(name: str) -> ctypes.CDLL:
    """Build if needed and load `lib<name>.so` once per process; a failure
    is raised again on every later call without another build."""
    with _LOCK:
        if name not in _loaded:
            try:
                _loaded[name] = ctypes.CDLL(str(build(name)))
            except (NativeUnavailable, OSError) as e:
                _loaded[name] = e if isinstance(e, NativeUnavailable) else \
                    NativeUnavailable(f"lib{name}.so does not load: {e}")
        got = _loaded[name]
    if isinstance(got, NativeUnavailable):
        raise got
    return got
