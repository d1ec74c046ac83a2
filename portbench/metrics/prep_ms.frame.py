"""Milliseconds of one synchronised `render.prepare_scene` call on the
cell's scene, camera and settings: the median of the traced run's calls."""


def read(run):
    from portbench.harness import span_ms

    return span_ms(run, "prepare_scene")
