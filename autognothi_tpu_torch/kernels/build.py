"""Build and load the CUDA kernels of `csrc/`.

The sources are compiled at first use with `nvcc` for `sm_90a`, one
`nvcc` process per `.cu` file, all started together, and linked into one
shared library with a plain C interface, loaded with `ctypes`.  The build
goes into `<repo>/build/kernels/<hash of sources and flags>/`, a directory
git ignores, so a fresh checkout builds everything it runs.  A missing
`nvcc` or a failed build raises with the compiler's output: nothing falls
back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libautognothi_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> (restype, argtypes); every pointer and the stream are c_void_p
_SIGNATURES = {
    "ag_gemm": (_I, [_I, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _P, _I, _P,
                     _I, _I, _I, _I, _P]),
    "ag_rowstats": (_I, [_I, _P, _I, _I, _F, _P, _P, _P]),
    "ag_layernorm": (_I, [_I, _P, _I, _I, _F, _P, _P, _P, _P]),
    "ag_attention": (_I, [_I, _I, _P, _P, _P,
                          ctypes.POINTER(ctypes.c_longlong), _P, _I, _P, _I,
                          _I, _I, _I, _I, _P]),
    "ag_attention_supports": (_I, [_I, _I]),
    "ag_quant_rows": (_I, [_I, _P, _I, _I, _I, _F, _P, _P, _I, _P, _P, _P,
                           _I, _P]),
    "ag_gemm_i8": (_I, [_I, _I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _P,
                        _P, _P, _I, _P, _I, _I, _I, _P]),
    "ag_gemm_i8_tiles_n": (_I, [_I]),
    "ag_gemm_i8_qa": (_I, [_I, _P, _I, _P, _P, _P, _P, _P, _I, _P, _I, _I,
                           _I, _I, _P]),
    "ag_mlp_narrow_supports": (_I, [_I, _I]),
    "ag_mlp_narrow": (_I, [_I, _I, _P, _I, _P, _P, _F, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _I, _I, _I, _P]),
    "ag_head_d1": (_I, [_I, _P, _I, _P, _P, _F, _P, _P, _P, _P, _P, _I, _I,
                        _I, _P]),
    "ag_fold_sum": (_I, [_I, _P, _I, _I, _I, _P, _P, _P]),
    "ag_gemm_wg": (_I, [_I, _I, _P, _I, _P, _P, _I, _P, ctypes.POINTER(_P),
                        _I, _P, _I, ctypes.c_longlong, _I, _I, _I, _I, _I,
                        _P]),
    "ag_rows_prep": (_I, [_I, _P, _I, _I, _I, _F, _P, _P, _P, _P]),
    "ag_ladder_supports": (_I, [_I]),
    "ag_ladder_stage": (_I, [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                             _P, _P, _F, _P, _I, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""       # the compiler's output of the build this process ran
build_seconds = 0.0  # 0.0 when the library was already built


def sources() -> list:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc: the port's "
        "CUDA kernels cannot be built on this host")


def build() -> pathlib.Path:
    """Compile the sources unless this exact build exists; -> the library."""
    global build_log, build_seconds
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    units = [p for p in sources() if p.suffix == ".cu"]
    objs = [out_dir / f"{p.stem}.{tag}.o" for p in units]
    t0 = time.perf_counter()
    procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                str(u)], stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True), u)
             for u, o in zip(units, objs)]
    logs, failed = [], []
    for proc, unit in procs:
        out, _ = proc.communicate()
        logs.append(f"== {unit.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{unit.name} (exit {proc.returncode})")
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(o) for o in objs)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link (exit {link.returncode})")
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{build_log}")
    (out_dir / "build.log").write_text(build_log)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


def compiler_log() -> str:
    """The compiler's output of the library this checkout loads (from the
    build this process ran, or saved beside the library by an earlier
    one); empty where none was kept."""
    if build_log:
        return build_log
    saved = BUILD_ROOT / source_hash() / "build.log"
    return saved.read_text() if saved.exists() else ""


def load() -> ctypes.CDLL:
    """The kernel library, built at first use; thread-safe."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


class LaunchCounter:
    """Calls of one op that went to its CUDA kernel (one call may be several
    launches).  Plain-version calls never count."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0
