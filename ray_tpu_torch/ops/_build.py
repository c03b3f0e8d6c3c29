"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

Each source compiles with its own `nvcc` process (all started together)
into an object with a plain C interface; the objects link into one shared
library under `ray_tpu_torch/ops/build/` (git-ignored), named by a hash of
the sources and flags so an edited source rebuilds. The library loads with
ctypes: no PyTorch headers, so a build takes seconds, not minutes.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the last build (None: loaded from disk)
build_log = ""         # nvcc output of the last build (ptxas register use)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of ray_tpu_torch "
                       "build on a machine with the CUDA toolkit")


def _sources():
    return sorted(_SRC_DIR.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(sources, so_path: Path) -> str:
    """One nvcc per source in parallel, then one link. Returns the log."""
    nvcc = _nvcc()
    tmp = so_path.parent / f"tmp-{os.getpid()}-{so_path.stem}"
    tmp.mkdir(parents=True, exist_ok=True)
    objs = [tmp / (src.stem + ".o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o",
                               str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    logs, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp / so_path.name),
         *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp / so_path.name, so_path)
    shutil.rmtree(tmp, ignore_errors=True)
    return "\n".join(logs)


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.rpa_unified_forward
    fn.argtypes = [p] * 9 + [i] * 8 + [ctypes.c_float, i, p]
    fn.restype = i
    lib.rpa_unified_workspace_bytes.argtypes = [i] * 6
    lib.rpa_unified_workspace_bytes.restype = ctypes.c_longlong
    fn = lib.rpa_forward
    fn.argtypes = [p] * 8 + [i] * 8 + [ctypes.c_float, i, p]
    fn.restype = i
    lib.rpa_workspace_bytes.argtypes = [i] * 7
    lib.rpa_workspace_bytes.restype = ctypes.c_longlong
    # flash launchers: pointers, then (b, sq, skv, h, hkv, d, causal),
    # scale, is_bf16, stream.
    for name, n_ptrs in (("flash_fwd_launch", 5), ("flash_bwd_dq_launch", 7),
                         ("flash_bwd_dkv_launch", 8)):
        fn = getattr(lib, name)
        fn.argtypes = [p] * n_ptrs + [i] * 7 + [ctypes.c_float, i, p]
        fn.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library():
    """Build (if the sources changed) and load the kernel library."""
    global _lib, build_seconds, build_log
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        so_path = BUILD_DIR / f"libray_tpu_torch_ops_{_digest(sources)}.so"
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            build_log = _compile(sources, so_path)
            build_seconds = time.perf_counter() - t0
        _lib = _bind(ctypes.CDLL(str(so_path)))
        return _lib


def check(code: int, what: str) -> None:
    """Raise for a non-zero cudaError_t returned by a launcher."""
    if code != 0:
        msg = _lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
