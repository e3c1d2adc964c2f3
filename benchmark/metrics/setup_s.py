"""setup_s (s): from the process's start to the window's (host clock):
import, kernel build or load, weights, calibration, bake and prepare, the
gate, warm-up and the input pool."""


def read(run):
    return run.times["setup_s"]
