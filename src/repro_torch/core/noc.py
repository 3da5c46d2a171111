"""Cycle-accurate Hoplite NoC model (Kapre & Gray, FPL'15) in torch.

Hoplite is a unidirectional 2D torus with deflection routing and no
buffering: each router owns two pipeline registers (E and S outputs), takes
inputs from its west and north neighbours plus a local PE injection port, and
routes dimension-ordered (X then Y).

Arbitration (documented policy, faithful to Hoplite's austere router):
  * N input has priority (it already turned onto the Y ring);
  * a W packet that wants S/eject but loses arbitration deflects E (stays on
    the X ring and comes around);
  * a N packet never needs deflection: it only competes for S/eject and wins
    both (N at destination always ejects because N has eject priority);
  * PE injection is lowest priority and stalls until its port is free;
    a local packet (dst == self) consumes the eject port for one cycle.

Packet layout: the reference keeps a dict of six [nx, ny] fields. Here the
six fields are stacked in ONE int32 tensor ``[6, nx, ny]`` (order
:data:`PKT_FIELDS`; ``valid`` as 0/1, ``value`` as the float32 bit pattern),
so a torus shift or a select moves every field in one tensor op. Fields of
an invalid packet keep whatever the reference would keep there, so the state
converts leaf for leaf (:func:`pack`, :func:`unpack`).

Torus links are :func:`torch.roll` on a single device; on a grid sharded
over a mesh, :mod:`repro_torch.core.distributed` passes shifts that roll the
tile and exchange its edge with the neighbouring tiles.
"""
from __future__ import annotations

import torch

PKT_FIELDS = ("valid", "dst_x", "dst_y", "dst_slot", "opidx", "value")
VALID, DST_X, DST_Y, DST_SLOT, OPIDX, VALUE = range(len(PKT_FIELDS))


def empty_packets(nx: int, ny: int, *, device) -> torch.Tensor:
    return torch.zeros((len(PKT_FIELDS), nx, ny), dtype=torch.int32,
                       device=device)


def pack(fields: dict) -> torch.Tensor:
    """Field dict (bool valid, int32 ids, float32 value) -> [6, nx, ny]."""
    return torch.stack([
        fields["valid"].to(torch.int32),
        fields["dst_x"].to(torch.int32),
        fields["dst_y"].to(torch.int32),
        fields["dst_slot"].to(torch.int32),
        fields["opidx"].to(torch.int32),
        fields["value"].to(torch.float32).view(torch.int32),
    ])


def unpack(p: torch.Tensor) -> dict:
    """[6, nx, ny] -> field dict in the reference's dtypes."""
    return dict(valid=p[VALID] != 0, dst_x=p[DST_X], dst_y=p[DST_Y],
                dst_slot=p[DST_SLOT], opidx=p[OPIDX],
                value=p[VALUE].view(torch.float32))


def pk_where(cond, a, b):
    return torch.where(cond, a, b)


def pk_invalidate(p, keep):
    return torch.cat((p[:VALID + 1] * keep, p[VALID + 1:]))


def roll_shift_e(link_e):
    """Packet on (x, y)'s E register arrives at (x+1, y)'s W input."""
    return torch.roll(link_e, 1, dims=1)


def roll_shift_s(link_s):
    return torch.roll(link_s, 1, dims=2)


def grid_coords(nx: int, ny: int, *, device):
    """([nx, 1], [1, ny]) int32 router coordinates."""
    return (torch.arange(nx, dtype=torch.int32, device=device)[:, None],
            torch.arange(ny, dtype=torch.int32, device=device)[None, :])


def router_cycle(link_e, link_s, inject, *, shift_e=roll_shift_e,
                 shift_s=roll_shift_s, x0=0, y0=0, eject_capacity=1,
                 eject_policy="n_first", coords=None):
    """One NoC cycle for every router in parallel.

    Args:
      link_e, link_s: packets on the E/S output registers, [6, nx, ny].
      inject: packet offered by each PE this cycle, [6, nx, ny].
      shift_e/shift_s: torus shift implementations (a local roll, or a roll
        plus the edge exchange of a sharded grid).
      x0, y0: global coordinate offsets of this router tile (0 on a single
        device); added to ``coords``.
      eject_capacity: PE packets/cycle. 2 models the paper's §II-C BRAM
        multipumping: N and W can eject in the same cycle.
      eject_policy: single-port eject arbitration. ``"n_first"`` (N always
        beats W) or ``"priority"`` (the packet for the lower, i.e. more
        critical, ``dst_slot`` wins; the losing N deflects south, the losing
        W east). Irrelevant when ``eject_capacity >= 2``.
      coords: precomputed :func:`grid_coords` of the tile (built here when
        None), before the offsets.

    Returns:
      (new_link_e, new_link_s, ejects [list of packets], accepted,
       deflected) — ``deflected`` is a dict of [nx, ny] int32 per-router
      counts of in-flight packets deflected this cycle, split by cause:
      ``"noc"`` (a W packet that wanted the S turn but lost it to a
      continuing N packet) and ``"eject"`` (a packet at its destination
      router that lost the eject port).
    """
    _, nx, ny = link_e.shape
    if coords is None:
        coords = grid_coords(nx, ny, device=link_e.device)
    my_x, my_y = coords
    if x0 or y0:
        my_x, my_y = my_x + x0, my_y + y0

    w_in = shift_e(link_e)   # arrives from the west
    n_in = shift_s(link_s)   # arrives from the north

    # Routing predicates of the three candidates (W, N, inject) at once.
    cand = torch.stack((w_in, n_in, inject))
    valid = cand[:, VALID] != 0
    xeq = cand[:, DST_X] == my_x
    yeq = cand[:, DST_Y] == my_y
    at_dst = valid & xeq & yeq
    wants_e = valid & ~xeq
    wants_s = valid & xeq & ~yeq
    w_at, n_at, inj_local = at_dst.unbind(0)

    # --- eject arbitration ---
    if eject_capacity >= 2:
        n_ej, w_ej = n_at, w_at                   # both may eject
    elif eject_policy == "priority":
        w_wins = w_at & n_at & (w_in[DST_SLOT] < n_in[DST_SLOT])
        n_ej = n_at & ~w_wins
        w_ej = w_at & (~n_at | w_wins)
    elif eject_policy == "n_first":
        n_ej = n_at
        w_ej = w_at & ~n_ej
    else:
        raise ValueError(
            f"unknown eject_policy {eject_policy!r}; use 'n_first' or 'priority'")
    eject = pk_where(n_ej, n_in, pk_invalidate(w_in, w_ej & ~n_ej))
    eject2 = pk_invalidate(w_in, w_ej & n_ej) if eject_capacity >= 2 else None

    # --- S output: N continues south unless it ejected ---
    n_takes_s = valid[1] & ~n_ej
    w_takes_s = wants_s[0] & ~n_takes_s
    w_s_lost = wants_s[0] & n_takes_s
    # --- E output: W continues east, or deflects E on any lost arbitration ---
    w_lost_ej = w_at & ~w_ej
    w_takes_e = wants_e[0] | w_s_lost | w_lost_ej

    deflected = dict(
        noc=w_s_lost.to(torch.int32),
        eject=w_lost_ej.to(torch.int32) + (n_at & ~n_ej).to(torch.int32))

    # --- PE injection (lowest priority) ---
    inj_e = wants_e[2] & ~w_takes_e
    inj_s = wants_s[2] & ~n_takes_s & ~w_takes_s
    if eject_capacity >= 2:
        taken = eject[VALID] != 0
        inj_ej = inj_local & (~taken | (eject2[VALID] == 0))
        inj_to_slot2 = inj_ej & taken             # first slot taken by network
        eject2 = pk_where(inj_to_slot2, inject, eject2)
        eject = pk_where(inj_ej & ~inj_to_slot2, inject, eject)
    else:
        inj_ej = inj_local & (eject[VALID] == 0)
        eject = pk_where(inj_ej, inject, eject)
    accepted = inj_e | inj_s | inj_ej

    new_e = pk_where(w_takes_e, w_in, pk_invalidate(inject, inj_e))
    new_s = pk_where(n_takes_s, n_in,
                     pk_where(w_takes_s, w_in, pk_invalidate(inject, inj_s)))
    ejects = [eject] if eject2 is None else [eject, eject2]
    return new_e, new_s, ejects, accepted, deflected


def links_empty(link_e, link_s):
    return ~(link_e[VALID] | link_s[VALID]).any()
