"""In-engine trace accumulation: the torch half of :mod:`repro_torch.telemetry`.

:func:`init` builds the zeroed trace leaves that ride the simulation state
under ``state["telem"]``; :func:`accumulate` is called once per cycle by
``overlay.make_cycle_fn`` with signals the cycle already computed. Both work
on [nx, ny] tensors, so the batched engine runs them on each element's views
and the megakernel keeps the same leaves in its arguments.

Bit-determinism contract: every increment is integer, PE-local, and (except
``stall_no_ready``, repaired by ``overlay.repair_telemetry``) zero at the
completed-overlay fixed point, so the chunk engines can over-simulate past
completion without drifting any trace.

:func:`accumulate` updates the leaves in place, and it never reads a device
value on the host: the bucket index stays a one-element tensor and each
bucketed leaf takes its row through ``index_add_``, so the cycle can be
captured into a CUDA graph with tracing on.
"""
from __future__ import annotations

import torch

from .spec import TelemetrySpec


def init(spec: TelemetrySpec, nx: int, ny: int, device=None) -> dict:
    """Zeroed trace leaves for one simulation on an nx x ny PE grid."""
    zb = lambda: torch.zeros((spec.buckets, nx, ny), dtype=torch.int32,
                             device=device)
    z2 = lambda: torch.zeros((nx, ny), dtype=torch.int32, device=device)
    t: dict = {}
    if spec.pe:
        t["pe_busy"] = zb()       # node fires          (sums to busy_cycles)
        t["pe_occ"] = zb()        # fanout-drain-occupied cycles
    if spec.links:
        t["link_e"] = zb()        # E output register valid
        t["link_s"] = zb()        # S output register valid
        t["defl_noc"] = zb()      # route-contention    (sums to noc_deflections)
        t["defl_eject"] = zb()    # eject-port losers   (sums to eject_deflections)
    if spec.eject:
        t["eject_grant"] = zb()   # eject-port grants   (sums to delivered)
    if spec.sched:
        t["ready_depth"] = zb()   # queued-ready nodes, summed per bucket
        t["pick_pos"] = z2()      # summed selected slot index
        t["picks"] = z2()         # number of committed picks
    if spec.stalls:
        t["stall_no_ready"] = z2()   # idle, nothing ready (overshoot-repaired)
        t["stall_inject"] = z2()     # injection offered but NoC-blocked
        t["stall_sel_wait"] = z2()   # pick held behind exposed select latency
    return t


def accumulate(spec: TelemetrySpec, t: dict, *, cycle, fired, occupied,
               link_e_busy, link_s_busy, defl_noc, defl_eject, eject_grant,
               ready_depth, sel, cand, no_ready, inj_blocked,
               sel_waiting) -> dict:
    """One cycle of trace increments, added to the leaves of ``t`` in place
    (``t`` is returned). All inputs are [nx, ny] signals the cycle already
    computed; ``cycle`` is the pre-increment 0-dim cycle counter, used as the
    bucket timestamp. The bucket index is clamped, so cycles past the
    horizon land in the last bucket and trace sums stay exactly equal to the
    scalar stat counters."""
    i32 = torch.int32
    b = torch.clamp(torch.div(cycle, spec.bucket_cycles, rounding_mode="floor"),
                    max=spec.buckets - 1).reshape(1)

    def bump(name, inc):
        t[name].index_add_(0, b, inc.to(i32)[None])

    if spec.pe:
        bump("pe_busy", fired)
        bump("pe_occ", occupied)
    if spec.links:
        bump("link_e", link_e_busy)
        bump("link_s", link_s_busy)
        bump("defl_noc", defl_noc)
        bump("defl_eject", defl_eject)
    if spec.eject:
        bump("eject_grant", eject_grant)
    if spec.sched:
        bump("ready_depth", ready_depth)
        t["pick_pos"].add_(torch.where(sel, cand, torch.zeros_like(cand)))
        t["picks"].add_(sel.to(i32))
    if spec.stalls:
        t["stall_no_ready"].add_(no_ready.to(i32))
        t["stall_inject"].add_(inj_blocked.to(i32))
        t["stall_sel_wait"].add_(sel_waiting.to(i32))
    return t
