"""The largest problem a user fits: the device memory allocated at its peak
over set-up and window, in GiB. The benchmark reads it on the host once
the window has closed, from PyTorch's caching allocator
(``torch.cuda.max_memory_allocated``), not from the program;
``BENCHMARK.json`` names an end-to-end metric's source only as
``host_clock`` or ``device_trace``, and gives this one as ``host_clock``."""


def read(run):
    return run.peak_bytes / 2**30
