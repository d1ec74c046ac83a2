"""Milliseconds a frame in which the device ran nothing while the host was
inside the program's `rtp.pass` span (`render.render_pass`)."""


def read(run):
    from portbench.spans import idle_ms

    return idle_ms(run, "rtp.pass")
