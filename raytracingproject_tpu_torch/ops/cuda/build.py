"""Build and bind csrc/megakernel.cu: nvcc into a shared library with a
plain C interface, loaded with ctypes.

The library is built at first use from the package's own source into the
package's `build/` directory (ignored by git), so a fresh checkout builds
everything it runs. There is no fallback: a missing nvcc or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE = PACKAGE_DIR / "csrc" / "megakernel.cu"
BUILD_DIR = PACKAGE_DIR / "build"
LIBRARY = BUILD_DIR / "libmegakernel.so"

# Hopper with its architecture-specific features (sm_90a). No
# --use_fast_math and no FMA contraction: IEEE sqrtf/logf/division and
# separately rounded products keep the kernel equal to its plain PyTorch
# version ray for ray. -Xptxas -v reports registers and spills per kernel.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# What the last build of this process reported (seconds, nvcc's stderr).
BUILD_INFO: dict[str, object] = {"seconds": None, "log": ""}
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_SIGNATURES = {
    "rtp_rays_per_block": ([], _I),
    "rtp_error_string": ([_I], ctypes.c_char_p),
    "rtp_trace_brute": ([_P, _P, _P, _P, _I, _P, _I, _U, _I, _F, _I, _P], _I),
    "rtp_trace_front": (
        [_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _U, _I, _F, _I, _P], _I,
    ),
    "rtp_record_brute": (
        [_P, _P, _P, _P, _I, _P, _I, _U, _I, _F, _I, _P, _P, _P, _P, _P, _P], _I,
    ),
    "rtp_record_front": (
        [_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _U, _I, _F, _I,
         _P, _P, _P, _P, _P, _P], _I,
    ),
    "rtp_philox": ([_P, _I, _U, _I, _P], _I),
}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, PATH or the toolkit's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        candidates.append(Path(which))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels into LIBRARY (atomically replaced)."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = res.stderr
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIBRARY)
    return LIBRARY


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or older than its
    source."""
    global _lib
    if _lib is not None:
        return _lib
    if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
        build()
    lib = ctypes.CDLL(str(LIBRARY))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    _lib = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().rtp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
