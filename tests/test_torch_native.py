"""The port stands alone: it reads no file of the JAX package. Its native
sources are its own copies (the originals' code byte for byte; one comment
line in each names the C++ reference's files as `src/...` without the
originals' absolute prefix), its build paths lie inside the package, and
no string literal of its modules names a path into raytracingproject_tpu/."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch import native
from raytracingproject_tpu_torch.bvh import _build_bvh_native, _build_bvh_python
from raytracingproject_tpu_torch.ops.cuda import build
from raytracingproject_tpu_torch.scene import make_three_sphere_scene

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "raytracingproject_tpu_torch"


@pytest.mark.parametrize("name", ["bvh_builder.cpp", "ppm_io.cpp"])
def test_native_sources_are_the_ports_own_copies(name):
    own = PORT / "native" / name
    assert own.is_file()
    original = (ROOT / "raytracingproject_tpu" / "native" / name).read_bytes()
    absolute = re.compile(rb"/[a-z]+/reference/src/")  # where the originals cite the reference
    assert len(absolute.findall(original)) == 1 and not absolute.search(own.read_bytes())
    assert own.read_bytes() == absolute.sub(b"src/", original)
    assert native.SOURCE_DIR == PORT / "native"
    assert native.BUILD_DIR.parent == PORT / "native"


def test_build_paths_lie_inside_the_port():
    assert set(build.LIBRARIES) == {"megakernel", "closest_hit", "probes"}
    for name in build.LIBRARIES:
        assert build.source(name).is_file() and build.source(name).parent == PORT / "csrc"
        assert build.library(name).parent == PORT / "build"


def _string_literals(tree):
    """Every str constant of a module but the docstrings."""
    doc = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                doc.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in doc:
            yield node.value


def test_no_module_names_a_path_into_the_jax_package():
    """Outside docstrings and comments no string of the port mentions
    `raytracingproject_tpu` (but as `raytracingproject_tpu_torch`), and no
    module imports it or jax; chip_smoke.py imports neither."""
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 20
    for src in files:
        tree = ast.parse(src.read_text())
        for text in _string_literals(tree):
            assert not re.search(r"raytracingproject_tpu(?!_torch)", text), (src, text)
    for src in [*files, ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(src.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "optax", "raytracingproject_tpu"), (src, n)


def test_native_bvh_builds_from_the_ports_copy():
    """With g++ the port's own bvh_builder.cpp builds and gives a tree
    that covers every sphere, like the Python build."""
    scene = make_three_sphere_scene()
    tree = _build_bvh_native(scene, 2)
    if tree is None:
        pytest.skip("no g++ on this host: the Python build is the route")
    ref = _build_bvh_python(scene, 2)
    assert sorted(tree.prim_order.tolist()) == sorted(ref.prim_order.tolist()) == [0, 1, 2, 3]
    assert int(tree.leaf_count.sum()) == 4 and torch.isfinite(tree.node_min).all()
    assert np.all(tree.node_min.numpy()[0] <= ref.node_min.numpy()[0] + 1e-5)


def test_ctypes_signatures_match_the_c_sources():
    """Every C entry point bound in `build.LIBRARIES` is declared in its
    source with the argument types the binding gives ctypes (a pointer as
    c_void_p, int, unsigned, float), in order: a mismatch would pass a cut
    or shifted argument to a kernel on the card and nothing on the CPU."""
    import ctypes

    c_types = {"int": ctypes.c_int, "unsigned": ctypes.c_uint, "float": ctypes.c_float}
    for name, entries in build.LIBRARIES.items():
        src = build.source(name).read_text()
        extern = src[src.index('extern "C"'):]
        for fn, (argtypes, _) in entries.items():
            m = re.search(rf"\b(?:int|const char\*) {fn}\(([^)]*)\)", extern)
            assert m, fn
            declared = []
            for param in filter(None, (x.strip() for x in m.group(1).split(","))):
                words = param.replace("*", " * ").split()[:-1]  # drop the parameter's name
                words = [w for w in words if w != "const"]
                declared.append(ctypes.c_void_p if "*" in words else c_types[" ".join(words)])
            assert declared == list(argtypes), fn
