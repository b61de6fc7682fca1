"""Set-up: from the process's start to the first timed solve (imports, the
CUDA context, the kernel library, the operators, one warm-up solve)."""


def read(run):
    return run.setup_s
