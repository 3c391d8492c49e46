"""Set-up: process start to the end of the first (warm) call, which builds
or finds the kernels, builds the network from the seed, loads it and
captures the call's graphs."""


def read(run: dict):
    return run["setup_s"]
