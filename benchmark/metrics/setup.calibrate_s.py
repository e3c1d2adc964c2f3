"""setup.calibrate_s (s): the port's ``calibrate`` over the calibration
batch, host clock, the device synchronized before and after."""


def read(run):
    return run.times["calibrate_s"]
