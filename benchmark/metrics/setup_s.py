"""Seconds from the process's start to the window's first step: imports,
the program's kernels from its build directory, the traffic's batches,
the weights on the card, every step's warm-up and capture."""


def read(record):
    return record["setup_s"]
