"""Build and bind the CUDA sources under csrc/: nvcc turns each into a
shared library with a plain C interface, loaded with ctypes.

Each library is built at first use from the package's own source into the
package's `build/` directory (ignored by git), so a fresh checkout builds
everything it runs; `build()` compiles several sources at once, one nvcc
process each. There is no fallback: a missing nvcc or a failed build
raises.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
BUILD_DIR = PACKAGE_DIR / "build"

# Hopper with its architecture-specific features (sm_90a). No
# --use_fast_math and no FMA contraction: IEEE sqrtf/logf/division and
# separately rounded products keep each kernel equal to its plain PyTorch
# version ray for ray. -Xptxas -v reports registers and spills per kernel.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# What the last build of this process reported (seconds of the whole
# build, nvcc's stderr of every source).
BUILD_INFO: dict[str, object] = {"seconds": None, "log": ""}
_libs: dict[str, ctypes.CDLL] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_ERROR_STRING = ([_I], ctypes.c_char_p)
_RES = [_P] * 5  # residual planes idx, ndx, ndy, ndz, refl
_MISS = [_P, _P]  # record_miss planes mdir, mthr (or nulls)
# sph, n_cols, ff, fi, n_front, wf, .., repack, then K3's options bf, n_bf, ksub, word_earlyout
_FRONT = [_P, _I, _P, _P, _I, _P, _I, _P, _I, _I, _P, _I, _I, _I]
_SEG = [_U, _I, _I, _F, _I, _I, *_RES, _P]  # seed, bounce0, depth, t_min, zero, miss, res, stream
# library name (csrc/<name>.cu -> build/lib<name>.so) -> its C entry points
LIBRARIES = {
    "megakernel": {
        "rtp_rays_per_block": ([], _I),
        "rtp_error_string": _ERROR_STRING,
        "rtp_trace_front": ([_P, _P, _P, _P, _I, *_FRONT, _U, _I, _F, _I, *_MISS, _P], _I),
        "rtp_record_front": ([_P, _P, _P, _P, _I, *_FRONT, _U, _I, _F, _I, *_RES, _P], _I),
        "rtp_trace_brute_chunked": (
            [_P, _P, _P, _P, _I, _P, _I, _U, _I, _F, _I, *_MISS, _P], _I,
        ),
        "rtp_trace_brute_chunked_schlick3": (
            [_P, _P, _P, _P, _I, _P, _I, _U, _I, _F, _I, _P], _I,
        ),
        "rtp_record_brute_chunked": (
            [_P, _P, _P, _P, _I, _P, _I, _U, _I, _F, _I, *_RES, _P], _I,
        ),
        "rtp_trace_bvh": ([_P, _P, _P, _P, _I, _P, _I, _P, _I, _U, _I, _F, _I, *_MISS, _P], _I),
        "rtp_record_bvh": (
            [_P, _P, _P, _P, _I, _P, _I, _P, _I, _U, _I, _F, _I, *_RES, _P], _I,
        ),
        "rtp_trace_front_hbm": (
            [_P, _P, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P, _I, _P, _I, _I, _I,
             _U, _I, _F, _I, *_MISS, _P], _I,
        ),
        "rtp_segment_brute_chunked": ([_P, _P, _P, _I, _P, _I, *_SEG], _I),
        "rtp_segment_front": ([_P, _P, _P, _I, *_FRONT, *_SEG], _I),
        "rtp_philox": ([_P, _I, _U, _I, _P], _I),
        # record, record_miss, segment -> blocks per SM (int out)
        "rtp_chunked_blocks_per_sm": ([_I, _I, _I, _P], _I),
        # record_miss -> blocks per SM
        "rtp_hbm_blocks_per_sm": ([_I, _P], _I),
        # record, record_miss -> blocks per SM
        "rtp_bvh_blocks_per_sm": ([_I, _I, _P], _I),
        # n_cols, n_front, n_words_pad, n_super, record, record_miss -> blocks per SM
        "rtp_front_blocks_per_sm": ([_I, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    },
    "closest_hit": {
        "rtp_error_string": _ERROR_STRING,
        "rtp_closest_hit": ([_P, _P, _P, _P, _I, _I, _F, _P, _P, _P], _I),
        "rtp_closest_hit_occupancy": ([_P, _P], _I),  # blocks per SM, threads (rays) a block
    },
    "probes": {
        "rtp_error_string": _ERROR_STRING,
        "rtp_probe_fma": ([_P, _P, _I, _P], _I),
        # variant, unroll, out, sph, n, 7 ray planes, out, n_rays, stream
        "rtp_probe_hit": ([_I, _I, _I, _P, _I, *[_P] * 7, _P, _I, _P], _I),
        # sph, n_cols, ff, fi, n_front, 7 ray planes, out, n_rays, stream
        "rtp_probe_front": ([_P, _I, _P, _P, _I, *[_P] * 7, _P, _I, _P], _I),
        # variant, unroll, out, n_cols, n_front -> blocks per SM
        "rtp_probe_blocks_per_sm": ([_I, _I, _I, _I, _I, _P], _I),
    },
}


def source(name: str) -> Path:
    return PACKAGE_DIR / "csrc" / f"{name}.cu"


def library(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


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


def build(names=None) -> None:
    """Compile the named sources (default: all) into their libraries, one
    nvcc process each, all started together; each library is replaced
    atomically."""
    names = list(LIBRARIES) if names is None else list(names)
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name in names:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, str(source(name))],
                                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        jobs.append((name, tmp, proc))
    logs, failed = [], []
    for name, tmp, proc in jobs:
        _, err = proc.communicate()
        logs.append(f"== {source(name).name} ==\n{err}")
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {source(name).name} ({proc.returncode}):\n{err}")
        else:
            os.replace(tmp, library(name))
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = "\n".join(logs)
    if failed:
        raise RuntimeError("\n".join(failed))


def kernel_registers(log: str) -> dict:
    """(registers, spill store bytes, stack frame bytes) of each kernel in
    nvcc's -Xptxas -v output `log`: an instantiation of trace_kernel keyed
    (mode, record, record_miss, segment, opt), any other kernel by its
    mangled name."""
    out, cur, spill, frame = {}, None, 0, 0
    for line in log.splitlines():
        if "Compiling entry" in line:
            cur = re.search(r"function '(\w+)'", line).group(1)
            m = re.search(r"trace_kernelILi(\d)ELb([01])ELb([01])ELb([01])ELi(\d)E", cur)
            cur = tuple(int(x) for x in m.groups()) if m else cur
            spill = frame = 0
        elif cur is not None and "spill stores" in line:
            spill = int(re.search(r"(\d+) bytes spill stores", line).group(1))
            frame = int(re.search(r"(\d+) bytes stack frame", line).group(1))
        elif cur is not None and re.search(r"Used \d+ registers", line):
            out[cur] = (int(re.search(r"Used (\d+) registers", line).group(1)), spill, frame)
            cur = None
    return out


def named(regs: dict, name: str) -> tuple[int, int, int]:
    """The entry of `kernel_registers` whose mangled name holds `name`."""
    return next(v for k, v in regs.items() if isinstance(k, str) and name in k)


def load_library(name: str = "megakernel") -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built first if it is missing or older
    than its source or a shared header (csrc/*.cuh)."""
    if name in _libs:
        return _libs[name]
    so, src = library(name), source(name)
    newest = max(p.stat().st_mtime for p in [src, *src.parent.glob("*.cuh")])
    if not so.exists() or so.stat().st_mtime < newest:
        build([name])
    lib = ctypes.CDLL(str(so))
    for fn_name, (args, res) in LIBRARIES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = args
        fn.restype = res
    _libs[name] = lib
    return lib


def check(err: int, what: str, name: str = "megakernel") -> None:
    """Raise if a C entry point of library `name` returned a CUDA error."""
    if err != 0:
        msg = load_library(name).rtp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
