"""The set-up time: the process's start to the window's first step."""


def read(run):
    return run.counters["setup_s"]
