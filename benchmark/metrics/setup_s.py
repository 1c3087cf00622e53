"""setup_s: process start to window start (host clock): the program's
imports, the traffic and the weights, the loaders and stores, every warm-up
step and graph capture, and, in a checkout's first run, nvcc."""


def read(ctx):
    return ctx.measure.get("setup_s")
