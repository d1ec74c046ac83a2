"""The chunked brute scan's partition of the work (csrc/megakernel.cu,
`closest_hit_chunked`, every brute scan of the port), modelled in plain
PyTorch and held bit for bit against the brute scan's plain version,
`closest_hit_brute_twin`.

On the card each of a block's L live rays gets G = the largest power of two
<= 256 / L of the block's threads. Lane g of a ray's group tests the
columns g, g + G, ... of each 1,024-column chunk in ascending order with a
strict `<`, carrying (t, column); then the group reduces (t, column)
lexicographically: an xor butterfly of shuffles over each 32-lane part,
then the parts in order. The model below does the same on the plain
version's candidate roots (`_sphere_t`), so the claim that the kernel
keeps the first minimum in column order, ties included, is checked for
every G, at chunk edges and on scenes with exact ties. A lane takes the
square root and the roots only where a pair's discriminant is positive;
`roots_only_t` models that and is held equal to the full test. The kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest
import torch

from raytracingproject_tpu_torch.config import T_MIN
from raytracingproject_tpu_torch.ops.cuda import megakernel as mk

THREADS = 256  # threads (rays) of a block, csrc/megakernel.cu TPB
CHUNK = 1024   # columns of a staged chunk, csrc/megakernel.cu CHUNK
WARP = 32
GROUPS = [1 << k for k in range(9)]  # every G a block can take: 1 .. 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One PyTorch CPU thread: the shapes are small, and a parallel test
    run's workers would otherwise oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def group_size(live: int) -> int:
    """G for `live` live rays: `1 << (31 - __clz(TPB / L))` in the kernel."""
    return 1 << ((THREADS // live).bit_length() - 1)


def _take_less(bt, bc, ot, oc):
    """Keep (ot, oc) where it is lexicographically less than (bt, bc)."""
    less = (ot < bt) | ((ot == bt) & (oc < bc))
    return torch.where(less, ot, bt), torch.where(less, oc, bc)


def partitioned_hit(t: torch.Tensor, g_size: int):
    """The kernel's closest hit of R rays from their [R, n] candidate t:
    (best t, winner column or -1), scanned and reduced as the kernel's
    lanes do for groups of `g_size` lanes."""
    r, n = t.shape
    inf = torch.tensor(math.inf, dtype=t.dtype)
    bt = torch.full((r, g_size), math.inf, dtype=t.dtype)
    bc = torch.zeros((r, g_size), dtype=torch.int64)
    lanes = torch.arange(g_size)
    for c0 in range(0, n, CHUNK):  # the last chunk is partial: its missing columns never win
        chunk = torch.full((r, CHUNK), math.inf, dtype=t.dtype)
        chunk[:, :min(CHUNK, n - c0)] = t[:, c0:c0 + CHUNK]
        strided = chunk.view(r, CHUNK // g_size, g_size)  # [ray, step, lane]: column step*G + lane
        for step in range(CHUNK // g_size):
            tk = strided[:, step, :]
            better = tk < bt  # strict: an equal t later in the lane's order loses
            bt = torch.where(better, tk, bt)
            bc = torch.where(better, c0 + step * g_size + lanes, bc)
    part = min(g_size, WARP)
    off = part // 2
    while off:  # __shfl_xor_sync within each 32-lane part
        bt, bc = _take_less(bt, bc, bt[:, lanes ^ off], bc[:, lanes ^ off])
        off //= 2
    wt, wc = bt[:, ::part], bc[:, ::part]  # one entry per part, read in order by the ray's thread
    best_t, best_c = wt[:, 0], wc[:, 0]
    for u in range(1, g_size // part):
        best_t, best_c = _take_less(best_t, best_c, wt[:, u], wc[:, u])
    return best_t, torch.where(best_t < inf, best_c, -1)


def _table(n: int, seed: int) -> np.ndarray:
    """A (16, n) float32 sphere table (mk.scene_table's rows), half the
    spheres moving."""
    rng = np.random.default_rng(seed)
    tab = np.zeros((mk.N_ROWS, n), np.float32)
    tab[mk.ROW_CX:mk.ROW_CZ + 1] = rng.uniform(-20.0, 20.0, (3, n))
    tab[mk.ROW_CY] = rng.uniform(-2.0, 4.0, n)
    tab[mk.ROW_MX:mk.ROW_MZ + 1] = rng.uniform(-0.5, 0.5, (3, n)) * (rng.random(n) < 0.5)
    tab[mk.ROW_RAD] = rng.uniform(0.2, 1.5, n)
    tab[mk.ROW_MAT] = rng.integers(0, 3, n)
    tab[mk.ROW_AR:mk.ROW_AB + 1] = rng.random((3, n))
    tab[mk.ROW_IOR] = 1.5
    return tab


def _tie_table() -> np.ndarray:
    """5,000 spheres with exact ties, above the random ones (y = 30), where
    rays from above reach them first: sphere 5 (moving) copied to columns
    in its own lane, in other lanes and in other chunks; sphere 600 to the
    first and last columns; and two spheres with coincident centres and
    equal radii in different chunks (their materials differ), with a
    smaller third on the same centre."""
    tab = _table(5000, seed=11)

    def place(col, x, rad):
        tab[mk.ROW_CX:mk.ROW_CZ + 1, col] = (x, 30.0, 0.0)
        tab[mk.ROW_MX:mk.ROW_MZ + 1, col] = 0.0
        tab[mk.ROW_RAD, col] = rad

    place(5, 0.0, 1.0)
    tab[mk.ROW_MX, 5] = 0.3
    place(600, 10.0, 1.0)
    for dst in (6, 38, 261, 1029, 2053, 4999):
        tab[:, dst] = tab[:, 5]
    for dst in (0, 4998):
        tab[:, dst] = tab[:, 600]
    for col, rad in ((1500, 0.8), (3100, 0.8), (4096, 0.5)):
        place(col, -10.0, rad)
    return tab


def _rays(tab: np.ndarray, n_rays: int, seed: int, aim=()):
    """Rays from 60 units above the spheres: half aimed at the centres (at
    the ray's time) of random spheres, the columns in `aim` first, the
    rest in random directions. Returns the nine planes the closest hits
    take (o xyz, d xyz, time, a, 1/a) as float32 tensors."""
    rng = np.random.default_rng(seed)
    tm = rng.random(n_rays, dtype=np.float32)
    targets = np.concatenate([np.asarray(aim, np.int64),
                              rng.integers(0, tab.shape[1], n_rays)])[:n_rays]
    centre = tab[mk.ROW_CX:mk.ROW_CZ + 1, targets] + tm * tab[mk.ROW_MX:mk.ROW_MZ + 1, targets]
    above = np.stack([3.0 * rng.normal(size=n_rays), np.full(n_rays, 60.0),
                      3.0 * rng.normal(size=n_rays)])
    o = (centre + above).astype(np.float32)
    d = (centre - o + rng.normal(scale=0.05, size=(3, n_rays))).astype(np.float32)
    stray = rng.random(n_rays) < 0.5
    stray[:len(aim)] = False
    d[:, stray] = rng.normal(size=(3, int(stray.sum())))
    ox, oy, oz, dx, dy, dz, tm = (torch.from_numpy(np.ascontiguousarray(x))
                                  for x in (*o, *d, tm))
    a = torch.clamp_min(dx * dx + dy * dy + dz * dz, 1e-20)
    return ox, oy, oz, dx, dy, dz, tm, a, 1.0 / a


def _hold(tab: np.ndarray, rays, g_size: int) -> None:
    """The model's (t, column) equal, bit for bit, to the plain version's."""
    t_tab = torch.from_numpy(tab)
    want_t, want_c = mk.closest_hit_brute_twin(t_tab, *rays, T_MIN)
    got_t, got_c = partitioned_hit(mk._sphere_t(t_tab, *rays, T_MIN), g_size)
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_c, want_c)
    assert bool((want_c >= 0).any())
    if len(want_c) >= 16:
        assert bool((want_c < 0).any())  # misses too


@pytest.mark.parametrize("g_size", GROUPS)
@pytest.mark.parametrize("n", [1023, 1024, 1025, 5000])
def test_groups_equal_plain_scan_at_chunk_edges(n, g_size):
    """Every G, on tables that end a column short of, at and a column past
    a chunk edge, and on five staged chunks."""
    tab = _table(n, seed=n)
    _hold(tab, _rays(tab, 48, seed=g_size, aim=(0, n - 1, min(1023, n - 1))), g_size)


@pytest.mark.parametrize("g_size", GROUPS)
def test_groups_keep_the_first_of_exact_ties(g_size):
    """Duplicated spheres in the same lane, other lanes and other chunks,
    and coincident centres: the least column wins every tie, at every G."""
    tab = _tie_table()
    rays = _rays(tab, 64, seed=3, aim=(5, 38, 1029, 4999, 600, 0, 4998, 1500, 3100, 4096))
    t_tab = torch.from_numpy(tab)
    _, win = mk.closest_hit_brute_twin(t_tab, *rays, T_MIN)
    assert win[:10].tolist() == [5] * 4 + [0] * 3 + [1500] * 3  # each tie kept by its first copy
    _hold(tab, rays, g_size)


@pytest.mark.parametrize("live", [1, 31, 33, 129, 256])
@pytest.mark.parametrize("ties", [False, True])
def test_live_counts_take_their_group_size(live, ties):
    """A block's L live rays with the G the kernel gives them (L = 1, 31,
    33, 129, 256: G = 256, 8, 4, 1, 1), on five chunks, with and without
    ties."""
    g_size = group_size(live)
    assert g_size * live <= THREADS < 2 * g_size * live
    tab = _tie_table() if ties else _table(5000, seed=5)
    aim = (5, 38, 1029, 600, 0, 1500) if ties else ()
    _hold(tab, _rays(tab, live, seed=live, aim=aim[:live]), g_size)


def test_group_size_is_the_largest_power_of_two_that_fits():
    """G * L threads of the block's 256 work, and doubling G would not fit."""
    for live in range(1, THREADS + 1):
        g_size = group_size(live)
        assert g_size & (g_size - 1) == 0 and g_size * live <= THREADS < 2 * g_size * live


def roots_only_t(tab: torch.Tensor, ox, oy, oz, dx, dy, dz, tm, a, inv_a) -> torch.Tensor:
    """[R, n] candidate t as the kernel's lanes compute it
    (`sphere_test_roots`): the discriminant of every pair, then the square
    root, the roots and the interval test on the pairs whose discriminant
    is positive alone; +inf elsewhere."""
    half_b, disc = mk._sphere_disc(tab, ox, oy, oz, dx, dy, dz, tm, a)
    t = torch.full_like(disc, math.inf)
    pos = disc > 0.0
    hb, dp = half_b[pos], disc[pos]
    ia = inv_a[:, None].expand_as(disc)[pos]
    sq = torch.sqrt(dp)
    r0, r1 = (-hb - sq) * ia, (-hb + sq) * ia
    t[pos] = torch.where(r0 > T_MIN, r0, torch.where(r1 > T_MIN, r1, math.inf))
    return t


@pytest.mark.parametrize("g_size", [1, 8, 256])
@pytest.mark.parametrize("ties", [False, True])
def test_roots_only_scan_equals_the_full_scan(g_size, ties):
    """A pair whose discriminant is not positive never updates the carry,
    so the scan that takes roots only where it is positive keeps the full
    test's candidates, bit for bit, and the partitioned scan over them the
    plain version's (t, column). Positive discriminants are rare, which is
    what skipping the roots buys."""
    tab = _tie_table() if ties else _table(5000, seed=21)
    rays = _rays(tab, 64, seed=g_size, aim=(5, 38, 1029, 600) if ties else ())
    t_tab = torch.from_numpy(tab)
    full = mk._sphere_t(t_tab, *rays, T_MIN)
    lean = roots_only_t(t_tab, *rays)
    assert torch.equal(lean, full)
    want_t, want_c = mk.closest_hit_brute_twin(t_tab, *rays, T_MIN)
    got_t, got_c = partitioned_hit(lean, g_size)
    assert torch.equal(got_t, want_t) and torch.equal(got_c, want_c)
    disc = mk._sphere_disc(t_tab, *rays[:8])[1]
    assert 0.0 < (disc > 0.0).double().mean().item() < 0.05


@pytest.mark.parametrize("n_spheres", [1, 487, 1024, 3000, 50000])
def test_every_brute_scan_takes_the_chunked_kernel(n_spheres):
    """Every scene size goes to the chunked kernel: the wrapper's brute scan
    hands the kernel the whole (16, N) table whatever N, the library has no
    whole-table brute entry point, and the launch counters name only the
    chunked route."""
    from raytracingproject_tpu_torch.ops.cuda import build
    from raytracingproject_tpu_torch.scene import make_random_scene

    scene = make_random_scene(n_spheres, seed=3)
    tab = mk._brute_scan(scene, torch.device("cpu"))
    assert tab.shape == (mk.N_ROWS, n_spheres) and tab.dtype == torch.float32
    entries = [n for n in build.LIBRARIES["megakernel"] if "brute" in n]
    assert entries and all("brute_chunked" in n for n in entries)
    assert all("brute_chunked" in k for k in mk.LAUNCHES if "brute" in k)
    source = build.source("megakernel").read_text()
    assert "BRUTE = 0" not in source and "closest_hit_brute(" not in source
