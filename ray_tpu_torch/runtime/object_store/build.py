"""Build the native object-store extension on demand.

The .so is compiled from this directory's store.cpp at first use, once per
checkout, into the package directory (git ignores `*.so`) and reused;
rebuilds happen when store.cpp is newer than the cached binary.
"""

import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "store.cpp")
_SO = os.path.join(_DIR, "_object_store.so")
_lock = threading.Lock()


def ensure_built() -> str:
    with _lock:
        if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            return _SO
        tmp = f"{_SO}.{os.getpid()}.tmp"  # pid-unique: concurrent builders race os.replace, which is atomic
        cmd = [
            "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
            "-o", tmp, _SRC, "-lpthread",
        ]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
        return _SO
