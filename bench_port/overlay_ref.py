"""Plain reference of the token-dataflow overlay (the paper's §II) that the
benchmark holds the port to. NumPy and plain PyTorch only; it imports
nothing of the port and takes nothing the port has made: it works out the
placement, the local-memory layout, every cycle and every node value again
from the raw graph (:mod:`arrow_lu`).

What it models, as the configuration files state it:

* Placement: node ``v`` on PE ``v mod P`` of the ``nx x ny`` grid (PE
  ``x * ny + y``).
* Local memory: a PE's nodes in decreasing criticality (height: the longest
  path to a sink, in edges), node id breaking ties (``"criticality"``), or
  in node id order (``"fifo"``).
* One cycle of every PE and Hoplite router: the active node offers its next
  fanout token; a unidirectional torus with E and S registers, X then Y,
  the N input first, a W packet that loses the S turn or the eject port
  deflects E, the PE's injection last and stalled until a port is free; one
  packet ejected a PE a cycle (``n_first``, capacity 1); a node fires the
  cycle its last operand lands and, with fanouts, joins its PE's ready set;
  an idle PE whose select wait has run out picks a ready node: ``ooo`` the
  first in local-memory order, ``inorder`` the oldest, ``lru_flat`` and
  ``scan`` the first at or after a rotating pointer. A pick costs the
  policy's select latency in exposed cycles.
* The run ends the first cycle after which every node is computed, no node
  is ready or active and the links are empty.

:func:`simulate` gives each run's cycles and counters, :func:`evaluate` the
node values (in float32, or in a lower precision for the control).
"""
from __future__ import annotations

import numpy as np
import torch

from .arrow_lu import OP_ADD, OP_DIV, OP_INPUT, OP_MUL, OP_SUB

DIV_EPS = 1e-3
POLICIES = ("ooo", "inorder", "lru_flat", "scan")
COUNTERS = ("delivered", "deflections", "busy_cycles", "noc_deflections",
            "eject_deflections")


def _csr_rounds(ptr: np.ndarray, dst: np.ndarray, n: int) -> np.ndarray:
    """[n] round at which Kahn's algorithm, run in synchronous rounds over
    the CSR graph (``ptr``, ``dst``), removes each node: 0 for nodes with
    no in-edge, else 1 + the largest round of a predecessor."""
    indeg = np.bincount(dst, minlength=n)
    rnd = np.full(n, -1, dtype=np.int64)
    frontier = np.flatnonzero(indeg == 0)
    r = 0
    while frontier.size:
        rnd[frontier] = r
        starts = ptr[frontier]
        counts = ptr[frontier + 1] - starts
        total = int(counts.sum())
        if total:
            first = np.cumsum(counts) - counts
            idx = np.repeat(starts - first, counts) + np.arange(total)
            nodes, dec = np.unique(dst[idx], return_counts=True)
            indeg[nodes] -= dec
            frontier = nodes[indeg[nodes] == 0]
        else:
            frontier = frontier[:0]
        r += 1
    if (rnd < 0).any():
        raise ValueError("graph has a cycle")
    return rnd


def prepare(struct: dict) -> dict:
    """What the reference derives once from a graph's structure (no seed):
    the producers of each operand, the ASAP level of each node (for
    :func:`evaluate`) and its height (for the criticality layout)."""
    ptr, dst = struct["fanout_ptr"], struct["fanout_dst"]
    n = struct["opcode"].shape[0]
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(ptr))
    operand_src = np.full((n, 2), -1, dtype=np.int64)
    operand_src[dst, struct["fanout_slot"].astype(np.int64)] = src
    level = _csr_rounds(ptr, dst, n)
    # Height: Kahn's rounds over the reversed graph (sinks are round 0).
    order = np.argsort(dst, kind="stable")
    rptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(rptr, dst + 1, 1)
    height = _csr_rounds(np.cumsum(rptr), src[order], n)
    by_level = np.argsort(level, kind="stable")
    level_ptr = np.searchsorted(level[by_level], np.arange(level.max() + 2))
    return dict(operand_src=operand_src, height=height, by_level=by_level,
                level_ptr=level_ptr)


def layout(struct: dict, prep: dict, num_pes: int, order: str):
    """(node_pe [N], node_slot [N], slots a PE [P]) of the round-robin
    placement with ``order`` = ``"criticality"`` or ``"fifo"``."""
    n = struct["opcode"].shape[0]
    ids = np.arange(n, dtype=np.int64)
    node_pe = ids % num_pes
    if order == "criticality":
        key = np.lexsort((ids, -prep["height"], node_pe))
    elif order == "fifo":
        key = np.lexsort((ids, node_pe))
    else:
        raise ValueError(f"unknown layout {order!r}")
    counts = np.bincount(node_pe, minlength=num_pes)
    first = np.cumsum(counts) - counts
    node_slot = np.empty(n, dtype=np.int64)
    node_slot[key] = np.arange(n) - first[node_pe[key]]
    return node_pe, node_slot, counts


def evaluate(struct: dict, prep: dict, init_values: np.ndarray,
             dtype=torch.float32) -> np.ndarray:
    """[N] node values: the DAG evaluated level by level in ``dtype``
    (``a / (b + eps)`` with ``eps`` of ``b``'s sign for DIV), as float32."""
    op = torch.from_numpy(struct["opcode"].astype(np.int64))
    val = torch.from_numpy(init_values).to(dtype)
    srcs = torch.from_numpy(prep["operand_src"])
    by_level = torch.from_numpy(prep["by_level"])
    bounds = prep["level_ptr"].tolist()
    eps = torch.tensor(DIV_EPS, dtype=dtype)
    zero = torch.zeros((), dtype=dtype)
    for lo, hi in zip(bounds[1:-1], bounds[2:]):
        nodes = by_level[lo:hi]
        a = val[srcs[nodes, 0]]
        b = val[srcs[nodes, 1]]
        o = op[nodes]
        safe_b = b + torch.where(b >= 0, eps, -eps)
        val[nodes] = torch.where(
            o == OP_ADD, a + b, torch.where(
                o == OP_SUB, a - b, torch.where(
                    o == OP_MUL, a * b, torch.where(
                        o == OP_DIV, a / safe_b, zero))))
    return val.to(torch.float32).numpy()


def simulate(struct: dict, prep: dict, nx: int, ny: int, runs: list,
             *, eject_policy: str = "n_first", eject_capacity: int = 1,
             max_cycles: int = 1_000_000) -> list[dict]:
    """Simulate ``runs`` side by side, each a dict with ``scheduler`` (one of
    :data:`POLICIES`), ``select_latency`` (exposed cycles a pick costs) and
    ``layout`` (``"criticality"`` or ``"fifo"``). Returns per run its
    ``cycles``, ``done`` and :data:`COUNTERS`, read the cycle it finished
    (or at ``max_cycles``)."""
    if eject_policy != "n_first" or eject_capacity != 1:
        raise ValueError("the reference models the n_first eject of capacity 1")
    P = nx * ny
    S = len(runs)
    ptr, dst = struct["fanout_ptr"], struct["fanout_dst"]
    n = struct["opcode"].shape[0]
    E = dst.shape[0]
    is_input = struct["opcode"] == OP_INPUT
    fanout = np.diff(ptr)
    layouts = {}
    for r in runs:
        if r["scheduler"] not in POLICIES:
            raise ValueError(f"unknown scheduler {r['scheduler']!r}")
        if r["layout"] not in layouts:
            layouts[r["layout"]] = layout(struct, prep, P, r["layout"])
    L = max(int(c.max()) for _, _, c in layouts.values())
    M = S * P

    # Per run: slot -> node, each edge's destination PE and global slot.
    slot_node = np.full((M, L), -1, dtype=np.int64)
    pending = np.zeros(M * L, dtype=np.int64)
    fo_flat = np.zeros(M * L, dtype=np.int64)
    e_pe = np.empty(S * E, dtype=np.int64)
    e_slot = np.empty(S * E, dtype=np.int64)
    ready = np.zeros((M, L), dtype=bool)
    fifo = np.full((M, L), -1, dtype=np.int64)
    count = np.zeros(M, dtype=np.int64)
    policy = np.zeros(M, dtype=np.int64)
    lat = np.zeros(M, dtype=np.int64)
    for b, r in enumerate(runs):
        node_pe, node_slot, _ = layouts[r["layout"]]
        rows = b * P + node_pe
        slot_node[rows, node_slot] = np.arange(n)
        flat = rows * L + node_slot
        pending[flat] = np.where(is_input, 0, 2)
        fo_flat[flat] = fanout
        e_pe[b * E:(b + 1) * E] = node_pe[dst]
        e_slot[b * E:(b + 1) * E] = (b * P + node_pe[dst]) * L + node_slot[dst]
        start = is_input & (fanout > 0)
        rs, ss = rows[start], node_slot[start]
        ready[rs, ss] = True
        o = np.lexsort((ss, rs))          # a FIFO starts in slot order
        rs, ss = rs[o], ss[o]
        np.add.at(count, rs, 1)
        first = np.searchsorted(rs, rs)
        fifo[rs, np.arange(rs.size) - first] = ss
        policy[b * P:(b + 1) * P] = POLICIES.index(r["scheduler"])
        lat[b * P:(b + 1) * P] = int(r["select_latency"])
    remaining = np.full(S, int((~is_input).sum()), dtype=np.int64)
    head = np.zeros(M, dtype=np.int64)
    is_fifo = policy == POLICIES.index("inorder")
    is_rot = (policy == POLICIES.index("lru_flat")) | (
        policy == POLICIES.index("scan"))
    rot_ptr = np.zeros(M, dtype=np.int64)
    cols = np.arange(L)

    # Router coordinates and torus neighbours (the W and N inputs).
    pe_of = np.arange(M) % P
    my_x, my_y = pe_of // ny, pe_of % ny
    base = np.arange(M) - pe_of
    w_src = base + ((my_x - 1) % nx) * ny + my_y
    n_src = base + my_x * ny + (my_y - 1) % ny
    # Destination coordinates by PE; index -1 (no packet) hits the sentinel.
    dx = np.append(np.arange(P) // ny, -1)
    dy = np.append(np.arange(P) % ny, -1)

    le_pe = np.full(M, -1, dtype=np.int64)
    le_sl = np.zeros(M, dtype=np.int64)
    ls_pe = np.full(M, -1, dtype=np.int64)
    ls_sl = np.zeros(M, dtype=np.int64)
    active = np.zeros(M, dtype=bool)
    cursor = np.zeros(M, dtype=np.int64)
    cend = np.zeros(M, dtype=np.int64)
    sel_wait = lat - 1
    stats = np.zeros((S, len(COUNTERS)), dtype=np.int64)
    out: list[dict | None] = [None] * S
    cycle = 0
    while cycle < max_cycles and any(o is None for o in out):
        # 1. the active node offers its next fanout token
        inj = active & (cursor < cend)
        cur = np.where(inj, cursor, 0)
        i_pe = np.where(inj, e_pe[cur], -1)
        i_sl = e_slot[cur]
        # 2. the routers
        w_pe, w_sl = le_pe[w_src], le_sl[w_src]
        n_pe, n_sl = ls_pe[n_src], ls_sl[n_src]
        w_x, w_y = dx[w_pe] == my_x, dy[w_pe] == my_y
        w_at = w_x & w_y
        w_wants_s = w_x & ~w_y
        w_wants_e = (w_pe >= 0) & ~w_x
        n_at = (dx[n_pe] == my_x) & (dy[n_pe] == my_y)
        n_takes_s = (n_pe >= 0) & ~n_at
        w_s_lost = w_wants_s & n_takes_s
        w_takes_s = w_wants_s & ~n_takes_s
        w_lost_ej = w_at & n_at
        w_takes_e = w_wants_e | w_s_lost | w_lost_ej
        ej = n_at | (w_at & ~n_at)
        ej_sl = np.where(n_at, n_sl, w_sl)
        i_x, i_y = dx[i_pe] == my_x, dy[i_pe] == my_y
        inj_e = inj & ~i_x & ~w_takes_e
        inj_s = i_x & ~i_y & ~n_takes_s & ~w_takes_s
        inj_ej = i_x & i_y & ~ej
        ej_sl = np.where(inj_ej, i_sl, ej_sl)
        ej |= inj_ej
        accepted = inj_e | inj_s | inj_ej
        le_pe = np.where(w_takes_e, w_pe, np.where(inj_e, i_pe, -1))
        le_sl = np.where(w_takes_e, w_sl, i_sl)
        ls_pe = np.where(n_takes_s, n_pe, np.where(
            w_takes_s, w_pe, np.where(inj_s, i_pe, -1)))
        ls_sl = np.where(n_takes_s, n_sl, np.where(w_takes_s, w_sl, i_sl))
        # Per run: S-turn losses, stalled injections, eject losses, ejects.
        counts = np.stack((w_s_lost, inj & ~accepted, w_lost_ej, ej)).reshape(
            4, S, P).sum(2)
        # 3. fanout cursors; a drained node leaves its PE idle
        cursor += accepted
        drained = active & (cursor >= cend)
        active &= ~drained
        sel_wait = np.where(drained, lat - 1, sel_wait)
        # 4. deliveries: a node fires when its last operand lands
        rows = np.flatnonzero(ej)
        gs = ej_sl[rows]
        pending[gs] -= 1
        fired = pending[gs] == 0
        fs = gs[fired]
        n_fired = np.bincount(fs // (P * L), minlength=S)
        remaining -= n_fired
        noc = counts[0] + counts[1]
        stats += np.stack((counts[3], noc + counts[2], n_fired, noc,
                           counts[2]), axis=1)
        push = fs[fo_flat[fs] > 0]
        if push.size:
            pr, ps = push // L, push % L
            f = is_fifo[pr]
            ready[pr[~f], ps[~f]] = True
            fr = pr[f]
            fifo[fr, (head[fr] + count[fr]) % L] = ps[f]
            count[pr] += 1
        # 5. idle PEs past their select wait pick a ready node
        idle = ~active
        have = count > 0
        sel = idle & (sel_wait == 0) & have
        sel_wait = sel_wait - (idle & have & (sel_wait > 0))
        picked = np.flatnonzero(sel)
        if picked.size:
            slot = np.empty(picked.size, dtype=np.int64)
            f = is_fifo[picked]
            fr = picked[f]
            slot[f] = fifo[fr, head[fr]]
            head[fr] = (head[fr] + 1) % L
            rot = is_rot[picked]
            rr = picked[rot]
            if rr.size:
                sub = ready[rr]
                after = sub & (cols >= rot_ptr[rr, None])
                slot[rot] = np.where(after.any(1), after.argmax(1),
                                     sub.argmax(1))
                rot_ptr[rr] = (slot[rot] + 1) % L
            oo = ~f & ~rot
            if oo.any():
                slot[oo] = ready[picked[oo]].argmax(1)
            nf = picked[~f]
            ready[nf, slot[~f]] = False
            count[picked] -= 1
            v = slot_node[picked, slot]
            bb = picked // P
            cursor[picked] = bb * E + ptr[v]
            cend[picked] = bb * E + ptr[v + 1]
            active[picked] = True
        cycle += 1
        # 6. termination
        for b in np.flatnonzero(remaining == 0):
            if out[b] is not None:
                continue
            lo, hi = b * P, (b + 1) * P
            if (count[lo:hi].any() or active[lo:hi].any()
                    or (le_pe[lo:hi] >= 0).any() or (ls_pe[lo:hi] >= 0).any()):
                continue
            out[b] = dict(cycles=cycle, done=True,
                          **dict(zip(COUNTERS, stats[b].tolist())))
    for b in range(S):
        if out[b] is None:
            out[b] = dict(cycles=cycle, done=False,
                          **dict(zip(COUNTERS, stats[b].tolist())))
    return out
