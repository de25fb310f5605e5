"""Set-up seconds: from the start of the process to the end of the warm
pass (importing torch, the CUDA contexts, loading or building the kernel
library, making the inputs, one pass of the cell's shapes)."""


def read(run):
    return run.setup_s
