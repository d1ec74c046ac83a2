"""Device milliseconds a frame of the megakernel (kernels named
trace_kernel), from the profiler's trace."""

from portbench.harness import kernel_ms as read  # noqa: F401
