"""Rank 0's device milliseconds a sharded train step in the collective
kernels (operations named nccl...) of the traced window, where the
program opens `rtp.shard.reduce.*` spans in it: the image's and the
loss's all-reduces and the gradients' (parallel/shard.py). Those spans
launch every collective of the window: the benchmark's own count of
non-finite steps goes over the host. None for a program without the
spans."""


def read(run):
    from portbench.spans import host_ms

    if host_ms(run, "rtp.shard.reduce.") is None:
        return None
    return run.trace.device_s("nccl") * 1e3 / run.trace.units
