"""Readers of the program's own spans in a traced run.

The port opens a profiler range at each layer boundary (`rtp.render`,
`rtp.prepare_scene`, `rtp.pass`, `rtp.sync.seed`, `rtp.fit.replay`, ...;
raytracingproject_tpu_torch/utils/profiling.py). They are host events of
the same torch.profiler trace as the device's kernels and copies, so they
share its clock. A span name ending in "." names every span under it
(`rtp.sync.` is each host wait).

Each reader returns milliseconds a unit of the traced window (`share`: a
per cent of one span's time), or None when the run has no trace, the
trace no device operation (a CPU run: no device clock to share) or no
unit, or no span of those names lies in the window (a program without the
spans).
"""

from __future__ import annotations


def _named(name: str, spans) -> bool:
    return any(name == s or (s.endswith(".") and name.startswith(s)) for s in spans)


def _union(intervals) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _intersection(a, b) -> float:
    """The length of the overlap of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _covered(run, *spans) -> list[tuple[float, float]] | None:
    """The union of the host events named by `spans`, clipped to the
    traced window (profiler microseconds), or None (see the module)."""
    tr = run.trace
    if tr is None or not tr.device or not tr.units:
        return None
    found = [(max(s, tr.start), min(e, tr.end)) for n, s, e, _ in tr.host
             if _named(n, spans) and e > tr.start and s < tr.end]
    return _union(found) if found else None


def host_ms(run, *spans) -> float | None:
    """Host milliseconds a unit inside the spans named by `spans`."""
    cov = _covered(run, *spans)
    if cov is None:
        return None
    return sum(e - s for s, e in cov) * 1e-3 / run.trace.units


def idle_ms(run, *spans) -> float | None:
    """Milliseconds a unit in which the device ran nothing while the host
    was inside the spans named by `spans`."""
    cov = _covered(run, *spans)
    if cov is None:
        return None
    return _intersection(run.trace.gaps(), cov) * 1e-3 / run.trace.units


def share(run, part: str, whole: str) -> float | None:
    """Per cent of the host time inside the spans named `whole` that lies
    inside the spans named `part` as well."""
    whole_cov, part_cov = _covered(run, whole), _covered(run, part)
    if whole_cov is None or part_cov is None:
        return None
    total = sum(e - s for s, e in whole_cov)
    return 100.0 * _intersection(part_cov, whole_cov) / total if total > 0 else None
