"""The megakernel's plan (which body runs a chunk, from the shapes alone) and
its graph tables (the read-only records the kernel reads, built from the
graph leaves). Both are host code and run here; the bodies themselves are
held to the plain chunk on the card (``test_torch_cuda.py``,
``chip_smoke.py``).
"""
import numpy as np
import pytest

from repro_torch.core import overlay
from repro_torch.core import workloads as wl
from repro_torch.core.partition import build_graph_memory
from repro_torch.kernels import megakernel as mk


def _shared_bytes(P, L, rdy):
    """The shared body's bytes: links of both parities (32 ints a PE, P
    rounded up to 32), and for RDY policies the RDY rows at an odd stride
    and one summary word per 32 RDY words."""
    pp = -(-P // 32) * 32
    W = L // 32
    S = -(-W // 32)
    return 4 * (pp * 32 + (pp * S + W * (pp + 1) if rdy else 0))


@pytest.mark.parametrize("nx,ny,L,members,ppt,threads", [
    (16, 16, 64, ("ooo",), 1, 256),              # n15072, W 2
    (16, 16, 480, ("ooo", "inorder"), 1, 256),   # n117972, W 15
    (16, 16, 1856, ("lru_flat",), 1, 256),       # n470772, W 58
    (2, 2, 3776, ("scan",), 1, 32),              # n15072 on 2x2, W 118
    (22, 23, 64, ("inorder",), 1, 512),          # 506 PEs, one a thread
    (36, 36, 32, ("ooo",), 4, 352),              # 1296 PEs, four a thread
])
def test_plan_takes_the_shared_body_where_it_fits(nx, ny, L, members, ppt,
                                                  threads):
    got = mk.plan(nx, ny, L, members)
    rdy = members != ("inorder",)
    assert got == mk.Plan("shared", ppt, threads, -(-nx * ny // 32) * 32,
                          -(-(L // 32) // 32),
                          _shared_bytes(nx * ny, L, rdy))
    assert got.smem_bytes <= mk.SHARED_BYTES
    assert got.threads * got.ppt >= nx * ny


def test_plan_takes_the_global_body_where_shared_memory_runs_out():
    # 48x48 PEs: the links and RDY rows exceed a CTA's 227 KB.
    got = mk.plan(48, 48, 32, ("ooo",))
    assert got == mk.Plan("global", 0, 576, 2304, 1, 0)
    # At 42x42 the links fit alone (inorder), not with the RDY rows.
    assert mk.plan(42, 42, 32, ("inorder",)).body == "shared"
    assert mk.plan(42, 42, 32, ("ooo",)).body == "global"
    # A batch needs the rows as soon as one member uses them.
    assert mk.plan(42, 42, 32, ("inorder", "scan")).body == "global"
    # Deep rows on a small grid.
    assert mk.plan(16, 16, 32 * 220, ("ooo",)).body == "global"
    # n470772 on 2x2: 3,678 RDY words a PE, 115 summary words.
    assert mk.plan(2, 2, 117696, ("ooo",)) == mk.Plan("global", 0, 32, 32,
                                                      115, 0)
    # Rows above 32 summary words that would fit in shared memory take the
    # global body's three-level pick all the same.
    assert _shared_bytes(4, 32 * 1025, True) <= mk.SHARED_BYTES
    assert mk.plan(2, 2, 32 * 1025, ("ooo",)).body == "global"


def test_plan_is_a_function_of_the_shapes_and_a_forced_body():
    assert mk.plan(16, 16, 64, ("ooo",)) == mk.plan(16, 16, 64, ("ooo",))
    forced = mk.plan(16, 16, 64, ("ooo",), body="global")
    assert (forced.body, forced.ppt, forced.smem_bytes) == ("global", 0, 0)
    with pytest.raises(ValueError, match="shared memory"):
        mk.plan(48, 48, 32, ("ooo",), body="shared")
    with pytest.raises(ValueError, match="body"):
        mk.plan(16, 16, 64, ("ooo",), body="local")


def test_plan_names_its_limits():
    # Any number of PEs: the global body loops over them (64x64: 4,096).
    assert mk.plan(49, 48, 32, ("ooo",)) == mk.Plan("global", 0, 576, 2368,
                                                    1, 0)
    assert mk.plan(64, 64, 32, ("ooo",)).threads == mk.MAX_THREADS
    # The shared body's top word covers 32,768 slots; the global body's
    # pick has a level more, 2**20 slots a PE.
    assert mk.plan(2, 2, 32 * 1024, ("ooo",)).body == "shared"
    assert mk.plan(2, 2, 32 * 1025, ("ooo",)).body == "global"
    assert mk.plan(1, 1, 2**20, ("ooo",)).summary_words == 1024
    with pytest.raises(ValueError, match="1048576 slots"):
        mk.plan(1, 1, 2**20 + 32, ("ooo",))
    # 32-bit offsets within an element.
    with pytest.raises(ValueError, match="32-bit"):
        mk.plan(1024, 1024, 1024, ("inorder",))
    with pytest.raises(ValueError, match="32-bit"):
        mk.plan(2**15, 1, 32, ("inorder",))


@pytest.mark.parametrize("n", [2, 4])
def test_graph_tables_hold_the_graph_leaves(n):
    gm = build_graph_memory(wl.arrow_lu_graph(3, 6, 4, seed=5), n, n,
                            criticality_order=True)
    g = overlay.device_graph(gm, device="cpu")
    slot_info, edges = (t.numpy() for t in mk.graph_tables(g))
    P, L, emax = n * n, gm.lmax, gm.emax
    assert slot_info.shape == (n, n, L, 2, 4)
    assert edges.shape == (n, n, emax, 4)
    slot_info = slot_info.reshape(P, L, 2, 4)
    edges = edges.reshape(P, emax, 4)
    dst = gm.e_dst_pe.astype(np.int64)
    want_edges = np.stack([dst // n, dst % n, gm.e_dst_slot,
                           gm.e_dst_opidx.astype(np.int64)], axis=-1)
    np.testing.assert_array_equal(edges, want_edges)
    base, count = gm.fo_base.astype(np.int64), gm.fo_count.astype(np.int64)
    np.testing.assert_array_equal(
        slot_info[:, :, 0],
        np.stack([base, base + count, gm.opcode, count], axis=-1))
    first = np.take_along_axis(
        want_edges, np.clip(base, 0, emax - 1)[..., None], axis=1)
    np.testing.assert_array_equal(slot_info[:, :, 1], first)
