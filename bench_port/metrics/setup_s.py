"""Seconds from the start of the run to the start of its window: loading,
the graph and its graph memories, kernel builds and warm-up calls."""


def read(ctx):
    return ctx["setup_s"]
