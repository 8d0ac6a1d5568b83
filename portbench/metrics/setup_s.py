"""Set-up: process start to the first timed request (kernel build or
load, weights, the program's set-up, warm-up)."""


def read(run, name):
    return run.setup_s
