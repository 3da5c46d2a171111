"""Device kernels executed per simulated cycle in the traced slice. Copies
and fills are not kernels."""


def read(ctx):
    p = ctx["profile"]
    if p is None or ctx["traffic"]["engine"] != "select":
        return None
    kernels = sum(1 for _, _, name in p["device_ops"]
                  if not name.startswith(("Memcpy", "Memset")))
    cycles = sum(c.sim["cycles"] for c in p["calls"] if c.sim)
    return kernels / cycles if kernels and cycles else None
