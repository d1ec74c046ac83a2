"""Host milliseconds a frame inside the program's `rtp.upload.*` spans: the
pass loop's copies from pageable host memory to the device. Each copy is
blocking, so the span holds the host's wait for the work queued before it
(the previous pass's megakernel) as well as the copy itself."""


def read(run):
    from portbench.spans import host_ms

    return host_ms(run, "rtp.upload.")
