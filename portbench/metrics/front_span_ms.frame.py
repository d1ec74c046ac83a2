"""Host milliseconds a frame inside the program's `rtp.prep.front` span: the
shared-memory front's build (`megakernel.front_tables`), kept or refused."""


def read(run):
    from portbench.spans import host_ms

    return host_ms(run, "rtp.prep.front")
