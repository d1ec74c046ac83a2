"""Host milliseconds of the path-replay backward of a train step
(`grad.fast._FastRadiance.backward`, synchronised at its start and end),
timed by the host clock in untraced steps before the traced window: the
median of those steps."""


def read(run):
    from portbench.harness import span_ms

    return span_ms(run, "replay")
