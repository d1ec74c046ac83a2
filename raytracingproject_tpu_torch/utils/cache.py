"""The kernels' build directory (counterpart of
raytracingproject_tpu/utils/cache.py).

The JAX package turns on XLA's persistent compilation cache. The port
compiles no programs at run time besides its CUDA sources, which
ops/cuda/build.py builds once into the package's `build/` directory and
reuses while the source is unchanged: that directory is the port's cache.
"""

from __future__ import annotations

from pathlib import Path


def enable_compilation_cache(path: str | None = None) -> Path:
    """The directory the CUDA kernels build into (ops.cuda.build.BUILD_DIR).
    It needs no enabling and cannot be moved: a `path` other than it
    raises."""
    from raytracingproject_tpu_torch.ops.cuda.build import BUILD_DIR

    if path is not None and Path(path).resolve() != BUILD_DIR:
        raise ValueError(f"the kernels build into {BUILD_DIR}, not {path}")
    return BUILD_DIR
