"""setup.deploy_s (s): the bake, the prepare pass and the first forward at
the cell's batch with its gate races (or cached verdicts), host clock, the
device synchronized before and after."""


def read(run):
    return run.times["deploy_s"]
