"""Host milliseconds a frame in which the host waits for the device, inside
the program's `rtp.sync.*` spans (reads of device values: the pass's seed,
the scene table in prep) and `rtp.upload.*` spans (blocking copies from
pageable host memory, which wait for the stream's queued work)."""


def read(run):
    from portbench.spans import host_ms

    return host_ms(run, "rtp.sync.", "rtp.upload.")
