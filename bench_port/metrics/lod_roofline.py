"""Share of the device-memory roofline that the leading-one kernels
(``lod_schedule_kernel``, ``lod_rotating_kernel``) of the traced slice
reach, in percent: the bytes each launch must move on the grid's rows of
RDY words (``bounds.lod_schedule_bytes``, ``bounds.lod_rotating_bytes``) at
the card's peak bandwidth (``peaks.json``), over their device time."""
from bench_port import bounds


def read(ctx):
    p = ctx["profile"]
    peak = next((v for k, v in ctx["peaks"].items()
                 if k in ctx["device_kind"]), None)
    if p is None or peak is None:
        return None
    rows, words = ctx["nx"] * ctx["ny"], ctx["shapes"]["W"]
    need, ns = 0, 0
    for _, d, name in p["device_ops"]:
        if "lod_schedule_kernel" in name:
            need += bounds.lod_schedule_bytes(rows, words)
        elif "lod_rotating_kernel" in name:
            need += bounds.lod_rotating_bytes(rows, words)
        else:
            continue
        ns += d
    if not ns:
        return None
    return 100.0 * need / peak["hbm_bytes_per_s"] / (ns * 1e-9)
