"""The port's BVH build, scene reorder, subtree front and front tables
against the JAX package: equal arrays."""

import numpy as np
import pytest
import torch

from raytracingproject_tpu import bvh as jbvh, scene as jscene
from raytracingproject_tpu.ops.pallas import megakernel as jmk

from raytracingproject_tpu_torch import bvh as pbvh, scene as pscene
from raytracingproject_tpu_torch.native import load_library as load_native
from raytracingproject_tpu_torch.ops.cuda import megakernel as pmk

EYE = (13.0, 2.0, 3.0)
SCENES = {
    "cover": (lambda m: m.make_cover_scene(seed=0), 8),
    "three": (lambda m: m.make_three_sphere_scene(), 2),
    "random150": (lambda m: m.make_random_scene(150, seed=3), 2),
}


@pytest.fixture(autouse=True, scope="module")
def _warm_thread_pool():
    """Run one large element-wise op before the first test. On this kind of
    host the first multi-threaded PyTorch op of a process can round one
    worker thread's share of its result differently (ROADMAP Queue 3: about
    one process in nine with 8 threads, none in 80 after such a warm-up),
    and the tests below compare two closest hits for exact equality."""
    x = torch.ones(1 << 22)
    float((x * 2.0 + 1.0).sqrt().sum())


def _pair(name):
    make, leaf = SCENES[name]
    return make(jscene), make(pscene), leaf


def _assert_bvh_equal(jb, pb):
    for f in jb._fields:
        np.testing.assert_array_equal(getattr(pb, f).numpy(), np.asarray(getattr(jb, f)),
                                      err_msg=f)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_build_bvh_native_and_reorder_equal(name):
    js, ps, leaf = _pair(name)
    jb, pb = jbvh.build_bvh(js, leaf_size=leaf), pbvh.build_bvh(ps, leaf_size=leaf)
    _assert_bvh_equal(jb, pb)
    jr, pr = jbvh.reorder_scene(js, jb), pbvh.reorder_scene(ps, pb)
    for f in jr._fields:
        np.testing.assert_array_equal(getattr(pr, f).numpy(), np.asarray(getattr(jr, f)))


def test_build_bvh_python_equal():
    js, ps = jscene.make_random_scene(60, seed=2), pscene.make_random_scene(60, seed=2)
    _assert_bvh_equal(jbvh._build_bvh_python(js, 3), pbvh._build_bvh_python(ps, 3))


@pytest.mark.parametrize("kw", [
    {"max_nodes": 24}, {"max_nodes": 48, "order_point": EYE}, {"max_nodes": 30, "max_count": 6},
])
def test_bvh_front_equal(kw):
    js, ps, leaf = _pair("random150")
    jf = jbvh.bvh_front(jbvh.build_bvh(js, leaf_size=leaf), **kw)
    pf = pbvh.bvh_front(pbvh.build_bvh(ps, leaf_size=leaf), **kw)
    for f in jf._fields:
        np.testing.assert_array_equal(getattr(pf, f), getattr(jf, f), err_msg=f)


def _front_pair(name, smem_budget=pmk.SMEM_BUDGET_BYTES, **kw):
    js, ps, leaf = _pair(name)
    jb, pb = jbvh.build_bvh(js, leaf_size=leaf), pbvh.build_bvh(ps, leaf_size=leaf)
    jt = jmk.front_tables(jbvh.reorder_scene(js, jb), jb, **kw)
    pt = pmk.front_tables(pbvh.reorder_scene(ps, pb), pb, smem_budget=smem_budget, **kw)
    for f in ("sph", "ff", "fi", "wf", "sf", "remap"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(jt, f)),
                                      err_msg=f)
    assert pt.repack == jt.repack
    return pt


@pytest.mark.parametrize("repack", [1, 2])
def test_front_tables_cover_equal(repack):
    pt = _front_pair("cover", order_point=EYE, repack=repack)
    assert pt.ff.shape == (8, 24) and pt.sph.shape == (16, 568)


def test_front_tables_two_words_equal():
    pt = _front_pair("random150", max_nodes=48, order_point=EYE)
    assert pt.wf.shape == (8, 2)


def test_front_tables_super_words_equal():
    """More than 576 subtrees: word boxes padded to a 24 multiple and
    super-word boxes. Tables only: such a front exceeds the kernel's shared
    memory, which front_tables reports."""
    js = jscene.make_random_scene(1300, seed=4)
    ps = pscene.make_random_scene(1300, seed=4)
    jb, pb = jbvh.build_bvh(js, leaf_size=2), pbvh.build_bvh(ps, leaf_size=2)
    jt = jmk.front_tables(jbvh.reorder_scene(js, jb), jb, max_nodes=600)
    pt = pmk.front_tables(pbvh.reorder_scene(ps, pb), pb, max_nodes=600, smem_budget=None)
    for f in ("sph", "ff", "fi", "wf", "sf", "remap"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(), np.asarray(getattr(jt, f)),
                                      err_msg=f)
    assert pt.ff.shape[1] == 600 and pt.wf.shape[1] == 48 and pt.sf.shape[1] == 2
    with pytest.raises(ValueError, match="shared memory"):
        pmk.front_tables(pbvh.reorder_scene(ps, pb), pb, max_nodes=600)


def test_front_tables_unported_options_raise():
    """The options that once raised here (sub_block, word_earlyout) now
    build their tables; an option that has no meaning still raises: a
    repack that does not divide 24."""
    _, ps, leaf = _pair("three")
    pb = pbvh.build_bvh(ps, leaf_size=leaf)
    rs = pbvh.reorder_scene(ps, pb)
    plain = pmk.front_tables(rs, pb)
    sub = pmk.front_tables(rs, pb, sub_block=True)
    assert sub.ksub == int(plain.fi[1].max()) // pmk.UNROLL and not sub.word_earlyout
    assert tuple(sub.bf.shape) == (8, plain.sph.shape[1] // pmk.UNROLL + sub.ksub)
    early = pmk.front_tables(rs, pb, word_earlyout=True)
    assert early.word_earlyout and early.bf is None and early.ksub == 0
    for f in ("sph", "ff", "fi", "wf", "sf", "remap"):
        assert torch.equal(getattr(sub, f), getattr(plain, f))
        assert torch.equal(getattr(early, f), getattr(plain, f))
    with pytest.raises(ValueError):
        pmk.front_tables(rs, pb, repack=5)


def test_default_front_nodes_equal():
    for n in (4, 150, 487, 5000, 10**6):
        assert pmk.default_front_nodes(n) == jmk.default_front_nodes(n)


def test_super_word_front_twin_matches_brute_twin():
    """The plain front closest hit on a three-level front gives the brute
    scan's radiance (zero draws, so only culling can differ)."""
    ps = pscene.make_random_scene(1300, seed=4)
    pb = pbvh.build_bvh(ps, leaf_size=2)
    rs = pbvh.reorder_scene(ps, pb)
    pt = pmk.front_tables(rs, pb, max_nodes=600, order_point=EYE, smem_budget=None)
    g = torch.Generator().manual_seed(0)
    n = 512
    o = torch.tensor(EYE).expand(n, 3).contiguous()
    target = torch.rand((n, 3), generator=g) * torch.tensor([20.0, 0.5, 20.0]) - \
        torch.tensor([10.0, 0.0, 10.0])
    d = (target - o).contiguous()
    t = torch.rand(n, generator=g)
    brute = pmk.trace_paths(o, d, t, rs, 3, 4, zero_draws=True)
    front = pmk.trace_paths(o, d, t, rs, 3, 4, front=pt, zero_draws=True)
    differ = (front != brute).any(dim=1)
    if differ.any():  # diagnostics for a failure seen twice and not reproduced since
        r = int(torch.nonzero(differ)[0])
        route = "native" if load_native("bvh_builder") is not None else "python"
        _, res_b = pmk.trace_record(o[r:r + 1], d[r:r + 1], t[r:r + 1], rs, 3, 4,
                                    zero_draws=True)
        _, res_f = pmk.trace_record(o[r:r + 1], d[r:r + 1], t[r:r + 1], rs, 3, 4, front=pt,
                                    zero_draws=True)
        pytest.fail(
            f"front != brute on {int(differ.sum())} of {n} rays (BVH build: {route}); first "
            f"differing ray {r}: o {o[r].tolist()} d {d[r].tolist()} t {float(t[r])}; "
            f"winners per bounce brute {res_b.idx[:, 0].tolist()} front "
            f"{res_f.idx[:, 0].tolist()}; radiance brute {brute[r].tolist()} front "
            f"{front[r].tolist()}")
