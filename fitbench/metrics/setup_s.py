"""setup_s: process start to the first timed fit (imports, the kernel
library's load or build, the inputs, the warm fit)."""


def read(run):
    return run.setup_s
