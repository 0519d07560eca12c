"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with `ctypes`. The build runs at first
use, from the sources in the checkout, into ``build/repro_torch/`` at the
root of the checkout; the library's name carries a hash of its source, so
an edited kernel is rebuilt and never mistaken for a stale one.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_VP, _I = ctypes.c_void_p, ctypes.c_int
# the C signature of each kernel's launcher: (name, argtypes)
_SIGNATURES = {
    "heap_step": ("heap_step_launch",
                  [_VP] * 12 + [ctypes.POINTER(_I), _VP] + [_I] * 8 + [_VP]),
    "paged_attention": ("paged_attention_launch",
                        [_VP] * 8 + [_I] * 10 + [_VP]),
    "buddy_traverse": ("buddy_traverse_launch", [_VP] * 4 + [_I] * 5 + [_VP]),
    "freelist": ("freelist_launch", [_VP] * 8 + [_I] * 3 + [_VP]),
    "flash_attention": ("flash_attention_launch",
                        [_VP] * 4 + [_I] * 9 + [_VP, ctypes.POINTER(_I)]),
}

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, then PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + ARCH.encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path."""
    out = library_path(name)
    if not out.exists():
        compile_source(CSRC / f"{name}.cu", out, verbose=verbose)
    return out


def compile_source(src: Path, out: Path, verbose: bool = False) -> None:
    """Compile one CUDA source into the shared library `out`.

    The library is written to a temporary name and renamed into place, so a
    concurrent or interrupted build never leaves a partial file behind."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    cmd = [nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
           "-fPIC", "-o", tmp, str(src)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stderr}")
        if verbose and proc.stderr:
            print(proc.stderr, end="")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_all(verbose: bool = False) -> dict:
    """Build every kernel at once, one ``nvcc`` each, all started together;
    returns {name: seconds until that build finished}."""
    def timed(name):
        t0 = time.perf_counter()
        build(name, verbose=verbose)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(_SIGNATURES)) as ex:
        futs = {n: ex.submit(timed, n) for n in _SIGNATURES}
        return {n: f.result() for n, f in futs.items()}


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = bind(build(name), name)
        return lib


def bind(path: Path, name: str) -> ctypes.CDLL:
    """Load the library at `path` and type the launcher of kernel `name`."""
    lib = ctypes.CDLL(str(path))
    fn_name, argtypes = _SIGNATURES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib
