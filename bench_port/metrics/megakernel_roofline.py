"""Share of the device-memory roofline that the ``mega_chunk_kernel``
launches of the traced slice reach, in percent: the bytes the slice's
simulations must move through the megakernel (``bounds.mega_sim_bytes``,
from each simulation's cycles, delivered packets, fired nodes and picks) at
the card's peak bandwidth (``peaks.json``), over the launches' device
time."""
from bench_port import bounds


def read(ctx):
    p = ctx["profile"]
    peak = next((v for k, v in ctx["peaks"].items()
                 if k in ctx["device_kind"]), None)
    if p is None or peak is None:
        return None
    ns = sum(d for _, d, name in p["device_ops"] if "mega_chunk_kernel" in name)
    P, W, picks = ctx["nx"] * ctx["ny"], ctx["shapes"]["W"], ctx["picks"]
    need = sum(bounds.mega_sim_bytes(
        P, W, ctx["kinds"][c.kind].scheduler, c.sim["cycles"],
        c.sim["delivered"], c.sim["busy_cycles"], picks)
        for c in p["calls"] if c.sim)
    if not ns or not need:
        return None
    return 100.0 * need / peak["hbm_bytes_per_s"] / (ns * 1e-9)
