"""``setup_s`` (s, host clock): from the process's start to the window's:
imports, the kernels' build or load, the inputs made from the seed and the
warm-up of every shape the cell uses."""


def read(record):
    return record.get("setup_s")
