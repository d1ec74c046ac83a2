"""Host milliseconds of a whole train step, to synchronised params, loss
and gradients, timed by the host clock in untraced steps before the
traced window (the same steps as `replay_ms.fit`): the median of those
steps."""


def read(run):
    from portbench.harness import span_ms

    return span_ms(run, "step")
