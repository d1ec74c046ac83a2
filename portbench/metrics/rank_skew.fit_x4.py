"""The ranks' imbalance in the replay: for each of the `SPAN_UNITS` steps
that every rank times under a host-only profiler before the traced
window, the slowest rank's `rtp.shard.backward` over the median of the
ranks' (parallel/shard.py), in per cent (100: even), the median over the
steps; read from each rank's spans (`run.rank_spans`). None for a program
without the span, or a run of one rank."""

import statistics


def read(run):
    times = [spans.get("rtp.shard.backward") for spans in run.rank_spans]
    if len(times) < 2 or not all(times):
        return None
    steps = min(len(t) for t in times)
    ratios = [max(t[k] for t in times) / statistics.median(t[k] for t in times)
              for k in range(steps)]
    return 100.0 * statistics.median(ratios)
