"""m=1 and m=2 build their op programs only when read, and give their
edges from the pattern until then (``core/methods.py``'s closed forms,
``Schedule.closed_form``).

Every view the closed form answers is held against the op walk of the
same schedule with its programs built: ``data_edges`` and
``data_edges_ext`` row for row and in order, the ``recv_slot_table``
join, ``rounds()``, the barrier views and ``schedule_shape_key``. The
programs built on read are held op for op against the reference's eager
generator, and ``torch_shard``'s single-device build against the build
of the walked schedule, table for table, with programs that raise if
read.
"""

import numpy as np
import pytest

from tpu_aggcomm_torch.backends import torch_shard
from tpu_aggcomm_torch.backends.torch_shard import TorchShardBackend
from tpu_aggcomm_torch.core.methods import compile_method
from tpu_aggcomm_torch.core.pattern import AggregatorPattern
from tpu_aggcomm_torch.core.schedule import (Schedule, barrier_rounds_of,
                                             barrier_signatures,
                                             check_barrier_symmetry,
                                             schedule_shape_key)

NS = (8, 13, 32, 100, 257)
AS = (1, 3, 14, None)            # None: a = n
CS = (1, 2, 3, 64, 999999999)
CASES = [(m, n, a, c, t) for m in (1, 2) for n in NS
         for a in sorted({n if a is None else a for a in AS if a is None
                          or a <= n})
         for c in CS for t in range(4)]


def _pattern(n, a, c, t, d=64):
    return AggregatorPattern(n, a, data_size=d, comm_size=c, placement=t,
                             proc_node=4)


def _pair(m, p):
    """(the schedule as compiled, the same schedule with its programs
    built, so that every view walks them)."""
    walked = compile_method(m, p)
    walked.programs
    assert walked.unbuilt_closed_form() is None
    return compile_method(m, p), walked


def _unreadable(s):
    """``s`` with programs that raise when read, and its closed form."""
    def read():
        raise AssertionError(f"m={s.method_id}: programs read")
    out = Schedule(s.pattern, s.method_id, s.name, read,
                   uses_rendezvous=s.uses_rendezvous)
    out.closed_form = s.closed_form
    return out


@pytest.mark.parametrize("m,n,a,c,t", CASES)
def test_closed_form_views_equal_the_op_walk(m, n, a, c, t):
    s, walked = _pair(m, _pattern(n, a, c, t))
    assert s.unbuilt_closed_form() is not None
    edges = s.data_edges()
    assert edges.dtype == np.int64 and edges.shape == (n * a, 5)
    np.testing.assert_array_equal(edges, walked.data_edges())
    np.testing.assert_array_equal(s.data_edges_ext(),
                                  walked.data_edges_ext())
    rt = walked.recv_slot_table()
    assert [rt[(x, y)] for x, y in edges[:, :2].tolist()] == \
        edges[:, 3].tolist()
    got, want = s.rounds(), walked.rounds()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert barrier_signatures(s) == barrier_signatures(walked)
    assert check_barrier_symmetry(s) == check_barrier_symmetry(walked) == ()
    assert barrier_rounds_of(s) == barrier_rounds_of(walked) == {}
    assert schedule_shape_key(s) == schedule_shape_key(walked)
    np.testing.assert_array_equal(torch_shard._schedule_edges(s),
                                  torch_shard._schedule_edges(walked))
    assert s.unbuilt_closed_form() is not None      # nothing above built
    # programs built on read: the generator's, op for op; the views then
    # walk them
    assert s.programs == walked.programs
    assert s.unbuilt_closed_form() is None


@pytest.mark.parametrize("m", (1, 2))
@pytest.mark.parametrize("n,a,c,t", [(8, 3, 2, 1), (32, 14, 3, 1),
                                     (100, 14, 999999999, 3),
                                     (257, 3, 64, 2)])
def test_programs_built_on_read_equal_the_reference_generator(m, n, a, c, t):
    """The reference's generator builds its programs eagerly; the port's,
    built on first read, are the same op for op."""
    pytest.importorskip("jax")
    from tpu_aggcomm.core.methods import compile_method as ref_compile
    from tpu_aggcomm.core.pattern import AggregatorPattern as RefPattern
    s = compile_method(m, _pattern(n, a, c, t))
    rs = ref_compile(m, RefPattern(n, a, data_size=64, comm_size=c,
                                   placement=t, proc_node=4))
    np.testing.assert_array_equal(s.data_edges(), rs.data_edges())

    def ops(progs):
        return [[(int(o.kind), o.peer, o.slot, o.peer2, o.slot2, o.round,
                  o.token, tuple(o.tokens), o.bucket.value, o.nbytes,
                  o.chan, o.from_stage, o.to_stage) for o in prog]
                for prog in progs]
    assert ops(s.programs) == ops(rs.programs)


@pytest.mark.parametrize("m", (1, 2))
@pytest.mark.parametrize("c", (3, 999999999))
def test_shape_key_and_edges_never_read_programs(m, c):
    s = _unreadable(compile_method(m, _pattern(32, 14, c, 1)))
    assert schedule_shape_key(s)[3] == ()
    assert barrier_rounds_of(s) == {}
    assert len(torch_shard.schedule_edges(s)) == 32 * 14
    with pytest.raises(AssertionError, match="programs read"):
        s.programs


def _host_tables(backend, s):
    """``_compiled``'s build of ``s`` on the CPU (its row-delivery tables
    and zero runs, as on the card) and the host tables it came from."""
    built = backend._compiled(s)
    _, host = backend._mesh_layout(s)
    return built, host


@pytest.mark.parametrize("m", (1, 2))
@pytest.mark.parametrize("n,a,c", [(256, 16, 64), (256, 64, 3),
                                   (1024, 64, 999999999), (1024, 16, 64)])
def test_torch_shard_build_reads_no_program_and_equals_the_walk(m, n, a, c):
    p = _pattern(n, a, c, 1)
    s, walked = _pair(m, p)
    got = _host_tables(TorchShardBackend(device="cpu"), _unreadable(s))
    want = _host_tables(TorchShardBackend(device="cpu"), walked)
    _assert_same_build(got, want)


def _assert_same_build(got, want):
    (gb, gh), (wb, wh) = got, want
    assert (gb.F, gb.Fs, gb.ndev, gb.bsz) == (wb.F, wb.Fs, wb.ndev, wb.bsz)
    for name in ("counts", "recv_base", "send_base"):
        np.testing.assert_array_equal(getattr(gb, name), getattr(wb, name))
    assert len(gh) == len(wh) == len(gb.rounds) == len(wb.rounds)
    for (gr, gpk, gsc, gnb), (wr, wpk, wsc, wnb) in zip(gh, wh):
        assert (gr, gnb) == (wr, wnb)
        np.testing.assert_array_equal(gpk, wpk)
        np.testing.assert_array_equal(gsc, wsc)
    for (gr, gtab, gnb), (wr, wtab, wnb) in zip(gb.rounds, wb.rounds):
        assert (gr, gnb, gtab.edges) == (wr, wnb, wtab.edges)
        np.testing.assert_array_equal(gtab.rows.src, wtab.rows.src)
        np.testing.assert_array_equal(gtab.rows.dst, wtab.rows.dst)
    assert gb.zero.runs == wb.zero.runs


@pytest.mark.slow
@pytest.mark.parametrize("c", (999999999, 64))
def test_theta_build_equals_the_op_walk(c):
    """The Theta flagship (16,384 ranks, 256 aggregators): the edge table
    and torch_shard's tables from the closed form equal those of the op
    walk. The walk alone takes about a minute, hence slow."""
    p = AggregatorPattern(16384, 256, data_size=2048, comm_size=c)
    s = _unreadable(compile_method(1, p))
    got = _host_tables(TorchShardBackend(device="cpu"), s)
    edges = torch_shard.schedule_edges(s)
    walked = compile_method(1, p)
    walked.programs
    np.testing.assert_array_equal(edges, torch_shard.schedule_edges(walked))
    del edges
    _assert_same_build(got, _host_tables(TorchShardBackend(device="cpu"),
                                         walked))
