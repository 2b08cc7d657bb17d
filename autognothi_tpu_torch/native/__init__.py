"""Native (C++) host components, loaded through ctypes (port of
`autognothi_tpu/native/__init__.py`).

A core is compiled at first use with `g++ -O2 -shared -fPIC -std=c++17`
into `<repo>/build/native/<hash of source and flags>/lib<stem>.so`, a
directory git ignores, never beside its source.  Every native core has a
pure-Python reference implementation that its call site takes where the
core is unavailable; a failed build is not hidden: the compiler's output
is written to stderr once per process and kept in `build_errors`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

HERE = pathlib.Path(__file__).resolve().parent
BUILD_ROOT = HERE.parents[1] / "build" / "native"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}
build_seconds: Dict[str, float] = {}  # stem -> seconds of this process's build
build_errors: Dict[str, str] = {}     # stem -> why it did not build or load


def library_path(stem: str) -> pathlib.Path:
    """Where `<stem>.cpp` is built: keyed by its bytes and the flags."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update((HERE / f"{stem}.cpp").read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{stem}.so"


def _build(stem: str) -> pathlib.Path:
    lib = library_path(stem)
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(["g++", *FLAGS, str(HERE / f"{stem}.cpp"), "-o",
                           str(tmp)], capture_output=True, text=True)
    build_seconds[stem] = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ exit {proc.returncode}\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def build_and_load(stem: str) -> Optional[ctypes.CDLL]:
    """The core `<stem>.cpp`, built if this exact build is missing, and
    loaded; None (after writing why to stderr, once) where it cannot be."""
    with _lock:
        if stem not in _libs:
            try:
                _libs[stem] = ctypes.CDLL(str(_build(stem)))
            except (OSError, RuntimeError) as err:
                _libs[stem] = None
                build_errors[stem] = str(err)
                print(f"autognothi_tpu_torch.native: the {stem} core is "
                      f"unavailable, its Python path runs instead: {err}",
                      file=sys.stderr, flush=True)
        return _libs[stem]
