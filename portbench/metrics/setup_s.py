"""setup_s: seconds from the process's start to the window's: imports, the
CUDA context, the data made from the seed, the program's set-up (the
cubic prefilter, kernel loads, or builds in a fresh checkout) and the
warm-up."""


def read(record):
    return record.get("setup_s")
