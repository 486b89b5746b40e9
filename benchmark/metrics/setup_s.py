"""Process start to the first timed solve: imports, data, upload,
warm-up and, in a checkout's first run, compilation."""


def read(run):
    return run.setup_s
