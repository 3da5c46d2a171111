"""Frozen bytes bounds of the port's kernels, counted from shapes and from
what a simulation returns, so that later changes to the program cannot move
the yardstick. Each counts bytes that the work must read or write at least
once, never what a kernel reads again.

* The megakernel (``mega_chunk_kernel``) keeps a PE's registers, its links
  and the active policy's RDY rows on chip for a chunk of ``K`` cycles, so
  a chunk must read them from the state and write them back: the links
  (``link_e``, ``link_s``: 6 int32 a PE each), the PE's registers
  (``active``, ``cursor``, ``cursor_end``, ``sel_wait``), the scheduler's
  per-PE state (``ooo``: the RDY rows; ``lru_flat`` and ``scan``: the rows
  and the pointer; ``inorder``: ``head`` and ``size``), and write its done
  trace (one byte a cycle). Beyond the chunks, each delivered packet must be
  routed by its edge record (``e_dst_pe``, ``e_dst_slot``, ``e_dst_opidx``)
  and written into its operand cell; each node that fires must read its
  opcode and write its value; each pick must read the node's
  ``fo_base`` and ``fo_count``, and under ``inorder`` push its slot into
  the FIFO and pop it again. Scalars are left out. The chunks, packets,
  fires and picks come from the simulation's own cycles and counters, so
  the count covers the cells a chunk touches and not the whole state.
* A leading-one step (``lod_schedule_kernel``, ``lod_rotating_kernel``) on
  ``p`` rows of ``w`` RDY words must read the words, the gates (one byte a
  row) and the rotating pointers (int32), and write the picked slots
  (int32) and the new words. Copied from the bytes column of
  ``chip_smoke.py``'s ``kernel_times``.
"""
from __future__ import annotations

import math

#: Cycles a chunk of the port's ``engine="megakernel"`` (its
#: ``resolve_check_every``), as ``chip_smoke.py``'s ``MEGA_K``.
MEGA_K = 32
#: Bytes a PE of the links (two directions of 6 int32 fields) and of its
#: registers (four int32).
LINK_BYTES, PE_BYTES = 2 * 6 * 4, 4 * 4
#: Bytes of one edge record (three int32) and of one operand cell (float32).
EDGE_BYTES, OPERAND_BYTES = 3 * 4, 4


def sched_chunk_bytes(policy: str, P: int, W: int) -> int:
    """The per-PE scheduler state of ``policy`` that a chunk holds on chip:
    ``P`` PEs of ``W`` RDY words."""
    if policy == "ooo":
        return 4 * P * W                      # rdy
    if policy in ("lru_flat", "scan"):
        return 4 * P * W + 4 * P              # rdy, ptr
    if policy == "inorder":
        return 2 * 4 * P                      # head, size
    raise ValueError(f"unknown policy {policy!r}")


def mega_sim_bytes(P: int, W: int, policy: str, cycles: int, delivered: int,
                   fired: int, picks: int, K: int = MEGA_K) -> int:
    """Bytes a solo megakernel simulation of ``cycles`` cycles under
    ``policy`` on ``P`` PEs of ``W`` RDY words must move, given the packets
    it ``delivered``, the nodes that ``fired`` and its ``picks`` (nodes
    with a fanout)."""
    chunk = (2 * (LINK_BYTES * P + PE_BYTES * P
                  + sched_chunk_bytes(policy, P, W)) + K)
    pick = 2 * 4 + (2 * 4 if policy == "inorder" else 0)
    return (math.ceil(cycles / K) * chunk
            + delivered * (EDGE_BYTES + OPERAND_BYTES)
            + fired * (4 + 4) + picks * pick)


def lod_schedule_bytes(p: int, w: int) -> int:
    """``lod_schedule_step`` on ``p`` rows of ``w`` words."""
    words = 4 * p * w
    return words + p + 4 * p + words


def lod_rotating_bytes(p: int, w: int) -> int:
    """``lod_rotating_schedule_step`` on ``p`` rows of ``w`` words."""
    words = 4 * p * w
    return words + 4 * p + p + 4 * p + words
