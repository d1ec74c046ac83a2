"""Gigabytes (10**9 bytes) of the fullest card's peak of allocated device
memory over set-up and the window (`torch.cuda.max_memory_allocated`,
read by the harness after the window): the card a fit holds. None where
nothing was read (a CPU run)."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
