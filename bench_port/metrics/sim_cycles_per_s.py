"""Simulated cycles a second: the cycles of every simulation the window
completed, over the window's wall seconds."""


def read(ctx):
    cycles = sum(c.sim["cycles"] for c in ctx["calls"] if c.sim)
    return cycles / ctx["window_s"] if cycles else None
