"""setup_s: seconds from the process's start to the end of set-up
(inputs from the seed, weights, every shape of the cell warmed)."""


def read(ctx):
    return ctx["setup_s"]
