"""Native (C++) host components, loaded with ctypes.

`bvh_builder.cpp` and `ppm_io.cpp` in this directory are the port's own
copies of the JAX package's native sources (the same code; a test holds
that), so the port works installed or copied without the JAX package.
g++ builds them on first use into this directory's `build/`, which git
ignores. Callers keep the pure-Python paths for a host without g++.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
from pathlib import Path

log = logging.getLogger("raytracingproject_tpu_torch.native")

SOURCE_DIR = Path(__file__).resolve().parent
BUILD_DIR = SOURCE_DIR / "build"
_libs: dict[str, ctypes.CDLL | None] = {}


def _compile(src: Path, out: Path) -> bool:
    BUILD_DIR.mkdir(exist_ok=True)
    # Build under a temporary name and rename: test workers may build the
    # same library at the same time.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, str(src)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.warning("native compile failed to launch: %s", e)
        os.unlink(tmp)
        return False
    if res.returncode != 0:
        log.warning("native compile failed:\n%s", res.stderr)
        os.unlink(tmp)
        return False
    os.replace(tmp, out)
    return True


def load_library(name: str) -> ctypes.CDLL | None:
    """Load (compiling if needed) lib<name>.so; None if unavailable."""
    if name in _libs:
        return _libs[name]
    so = BUILD_DIR / f"lib{name}.so"
    src = SOURCE_DIR / f"{name}.cpp"
    lib = None
    if not src.exists():
        log.warning("native source %s not found", src)
    elif (so.exists() and so.stat().st_mtime >= src.stat().st_mtime) or _compile(src, so):
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            log.warning("failed to load %s: %s", so, e)
    _libs[name] = lib
    return lib
