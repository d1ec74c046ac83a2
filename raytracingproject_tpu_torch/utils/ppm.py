"""PPM image IO (reference: src/color.h:14-35 writes P3 text; counterpart
of raytracingproject_tpu/utils/ppm.py)."""

from __future__ import annotations

import ctypes
import io
from pathlib import Path

import numpy as np


def encode_ppm(image_u8) -> str:
    """Encode a [H, W, 3] uint8 image (numpy or tensor) as ASCII P3, one
    pixel per line. Uses the native encoder when available."""
    if hasattr(image_u8, "detach"):
        image_u8 = image_u8.detach().cpu().numpy()
    img = np.ascontiguousarray(image_u8, np.uint8)
    h, w, _ = img.shape

    native = _encode_native(img, w, h)
    if native is not None:
        return native

    buf = io.StringIO()
    buf.write(f"P3\n{w} {h}\n255\n")
    for r, g, b in img.reshape(-1, 3):
        buf.write(f"{r} {g} {b}\n")
    return buf.getvalue()


def _encode_native(img: np.ndarray, w: int, h: int) -> str | None:
    from raytracingproject_tpu_torch.native import load_library

    lib = load_library("ppm_io")
    if lib is None:
        return None
    cap = 32 + 13 * w * h
    out = ctypes.create_string_buffer(cap)
    fn = lib.ppm_encode
    fn.restype = ctypes.c_long
    fn.argtypes = [
        np.ctypeslib.ndpointer(np.uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_long,
    ]
    nbytes = fn(img.reshape(-1), w, h, out, cap)
    if nbytes <= 0:
        return None
    return out.raw[:nbytes].decode("ascii")


def write_ppm(image_u8, path_or_file) -> None:
    """Write a [H, W, 3] uint8 image as P3 text (see encode_ppm)."""
    data = encode_ppm(image_u8)
    if hasattr(path_or_file, "write"):
        path_or_file.write(data)
    else:
        Path(path_or_file).write_text(data)


def read_ppm(path) -> np.ndarray:
    """Read an ASCII P3 PPM (plain or UTF-16 with BOM) into [H, W, 3] uint8."""
    raw = Path(path).read_bytes()
    if raw[:2] in (b"\xff\xfe", b"\xfe\xff"):
        text = raw.decode("utf-16")
    else:
        text = raw.decode("ascii")
    tokens = text.split()
    if tokens[0] != "P3":
        raise ValueError(f"not a P3 PPM: magic={tokens[0]!r}")
    w, h, maxval = int(tokens[1]), int(tokens[2]), int(tokens[3])
    vals = np.array(tokens[4 : 4 + w * h * 3], dtype=np.int64)
    if maxval != 255:
        vals = vals * 255 // maxval
    return vals.reshape(h, w, 3).astype(np.uint8)
