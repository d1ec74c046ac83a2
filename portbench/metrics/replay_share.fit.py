"""Per cent of a train step's host time (the program's `rtp.fit.step` span)
spent inside its `rtp.fit.replay` span (`grad.fast._FastRadiance.backward`:
the path replay and its autograd). The profiler lengthens every host
operation, the replay's ~17,000 most of all, so its milliseconds under the
profiler overstate the replay; a share of the traced step cancels most of
that lengthening."""


def read(run):
    from portbench.spans import share

    return share(run, "rtp.fit.replay", "rtp.fit.step")
