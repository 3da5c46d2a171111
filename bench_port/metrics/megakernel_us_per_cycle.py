"""Device microseconds of the ``mega_chunk_kernel`` launches in the traced
slice over the cycles its simulations advanced."""


def read(ctx):
    p = ctx["profile"]
    if p is None:
        return None
    ns = sum(d for _, d, name in p["device_ops"] if "mega_chunk_kernel" in name)
    cycles = sum(c.sim["cycles"] for c in p["calls"] if c.sim)
    return ns * 1e-3 / cycles if ns and cycles else None
