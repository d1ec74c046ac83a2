"""Host milliseconds a frame inside the program's `rtp.prepare_scene` span (the
`render.prepare_scene` call inside `render`), on the profiler's clock."""


def read(run):
    from portbench.spans import host_ms

    return host_ms(run, "rtp.prepare_scene")
