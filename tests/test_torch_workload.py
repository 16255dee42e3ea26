"""The ``tam`` workload driver of the port against the reference's.

The copied layers must equal the reference's: ``core/meta`` and
``core/workload`` (aggregator sets, sizes, fills, the metadata fields)
over every stripe, ``-c``, ``--mode`` and node map; every numpy engine's
recv and ``RouteStats``; the ``native*`` engines' recv against the numpy
oracle. The port's own parts are held to the reference byte for byte:
the proxy route's three index tables against a verbatim transcription of
the reference's loops (``tpu_aggcomm/tam/workload_engines.py:536-571``),
``cw_proxy_sim`` on the CPU against the reference's under JAX on the CPU,
the chain's end state against a numpy transcription of the reference's
scan body, and the vectorised verifier against ``verify_all`` on passes
and on every corruption of the reference's mutation tests. ``cli tam``
prints the reference's lines but the timing values. Sizes are n=7-64;
tolerance zero throughout (integer data movement).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tpu_aggcomm import cli as ref_cli  # noqa: E402
from tpu_aggcomm.core import meta as ref_meta  # noqa: E402
from tpu_aggcomm.core import topology as ref_topology  # noqa: E402
from tpu_aggcomm.core import workload as ref_workload  # noqa: E402
from tpu_aggcomm.core.pattern import reorder_ranklist as ref_reorder  # noqa: E402
from tpu_aggcomm.tam import workload_engines as ref_we  # noqa: E402

from tpu_aggcomm_torch import cli  # noqa: E402
from tpu_aggcomm_torch.backends import native  # noqa: E402
from tpu_aggcomm_torch.backends.torch_sim import NotPortedError  # noqa: E402
from tpu_aggcomm_torch.core import meta, topology, workload  # noqa: E402
from tpu_aggcomm_torch.core.pattern import reorder_ranklist  # noqa: E402
from tpu_aggcomm_torch.harness import chained  # noqa: E402
from tpu_aggcomm_torch.harness.verify import VerificationError  # noqa: E402
from tpu_aggcomm_torch.obs import ledger  # noqa: E402
from tpu_aggcomm_torch.tam import workload_engines as we  # noqa: E402

STRIPES = [0, 1, 2, 3]
# (nprocs, per_node, node map kind): -p 1, 4 and 8, an uneven last node,
# the round-robin map
TOPOLOGIES = [(8, 1, 0), (8, 4, 0), (16, 8, 0), (7, 3, 0), (10, 4, 1)]


def _pair(n, p, kind, blocklen, stripe, reorder=False):
    """(reference (na, wl), port (na, wl)) of one configuration."""
    rna = ref_topology.static_node_assignment(n, p, kind)
    na = topology.static_node_assignment(n, p, kind)
    rwl = ref_workload.initialize_setting(rna, blocklen, stripe)
    wl = workload.initialize_setting(na, blocklen, stripe)
    if reorder:
        rwl = dataclasses.replace(rwl, aggregators=ref_reorder(
            rna.node_of, rwl.aggregators, rna.nnodes))
        wl = dataclasses.replace(wl, aggregators=reorder_ranklist(
            na.node_of, wl.aggregators, na.nnodes))
    return (rna, rwl), (na, wl)


def _recv_equal(got, want):
    assert set(got) == set(want)
    for g in want:
        assert len(got[g]) == len(want[g])
        for s, w in enumerate(want[g]):
            np.testing.assert_array_equal(got[g][s], w)


def _flat(wl, recv) -> torch.Tensor:
    """A recv dict in the route's flat layout (aggregators in
    ``wl.aggregators`` order, then sources)."""
    return torch.from_numpy(np.concatenate(
        [np.asarray(recv[int(g)][s], dtype=np.uint8)
         for g in wl.aggregators for s in range(wl.nprocs)]))


# ---------------------------------------------------------------------------
# the copied layers

@pytest.mark.parametrize("stripe", STRIPES)
@pytest.mark.parametrize("n,p,kind", TOPOLOGIES)
def test_workload_and_meta_match_the_reference(n, p, kind, stripe):
    (rna, rwl), (na, wl) = _pair(n, p, kind, 5, stripe)
    np.testing.assert_array_equal(wl.aggregators, rwl.aggregators)
    np.testing.assert_array_equal(wl.msg_size, rwl.msg_size)
    np.testing.assert_array_equal(wl.is_aggregator, rwl.is_aggregator)
    assert (wl.total_bytes, wl.max_msg_size) == \
        (rwl.total_bytes, rwl.max_msg_size)
    for r in range(n):
        np.testing.assert_array_equal(wl.send_size(r), rwl.send_size(r))
        np.testing.assert_array_equal(wl.recv_size(r), rwl.recv_size(r))
        for got, want in zip(wl.make_send_bufs(r), rwl.make_send_bufs(r)):
            assert (got is None) == (want is None)
            if got is not None:
                np.testing.assert_array_equal(got, want)
    for co in (1, 2, 3):
        for mode in (0, 1):
            got = meta.aggregator_meta_information(na, wl.aggregators, co,
                                                   mode)
            want = ref_meta.aggregator_meta_information(
                rna, rwl.aggregators, co, mode)
            assert got.nprocs == want.nprocs
            np.testing.assert_array_equal(got.local_aggregators,
                                          want.local_aggregators)
            np.testing.assert_array_equal(got.owner_of, want.owner_of)
            np.testing.assert_array_equal(got.is_local_aggregator,
                                          want.is_local_aggregator)


@pytest.mark.parametrize("stripe", STRIPES)
@pytest.mark.parametrize("n,p,kind", TOPOLOGIES)
def test_numpy_and_native_engines_match_the_reference(n, p, kind, stripe):
    """Every oracle engine's recv and RouteStats equal the reference
    engine's; the C++ engines deliver the oracle's recv."""
    (rna, rwl), (na, wl) = _pair(n, p, kind, 5, stripe)
    co = max(1, min(p, 2))
    rmeta = ref_meta.aggregator_meta_information(rna, rwl.aggregators, co, 1)
    mt = meta.aggregator_meta_information(na, wl.aggregators, co, 1)
    for engine in ("benchmark", "proxy", "local_agg", "shared"):
        try:
            want, wstats = ref_we.run_workload_engine(engine, rwl, rna, rmeta)
        except ValueError as e:
            with pytest.raises(ValueError, match=re.escape(str(e))):
                we.run_workload_engine(engine, wl, na, mt)
            continue
        got, stats = we.run_workload_engine(engine, wl, na, mt)
        _recv_equal(got, want)
        assert dataclasses.asdict(stats) == dataclasses.asdict(wstats)
        assert stats.network_bytes == wstats.network_bytes
    oracle, _ = we.cw_proxy(wl, na)
    got, times = native.run_workload_proxy(wl, na, ntimes=2)
    _recv_equal(got, oracle)
    assert len(times) == 2
    got, _ = native.run_workload_cw2(wl, mt)
    _recv_equal(got, oracle)
    if all(mt.is_local_aggregator[int(d)] for d in wl.aggregators):
        got, _ = native.run_workload_cw3(wl, na, mt)
        _recv_equal(got, oracle)


def test_recv_index_map_matches_the_reference():
    (rna, rwl), (na, wl) = _pair(16, 4, 0, 5, 3)
    rmeta = ref_meta.aggregator_meta_information(rna, rwl.aggregators, 2, 0)
    mt = meta.aggregator_meta_information(na, wl.aggregators, 2, 0)
    assert we.recv_index_map(wl, mt) == ref_we.recv_index_map(rwl, rmeta)


@pytest.mark.parametrize("engine", ["jax", "shared_jax"])
def test_mesh_engines_are_refused_by_name(engine, capsys):
    """The mesh engines need one device per rank (the multi-device tier):
    refused before anything runs, one line naming ROADMAP A8."""
    with pytest.raises(SystemExit) as e:
        cli.main(["tam", "-n", "8", "-p", "4", "--engine", engine])
    msg = str(e.value.code)
    assert msg.startswith("NotPortedError: ") and "\n" not in msg
    assert "queue A item 8" in msg
    assert capsys.readouterr().out == ""
    (_, _), (na, wl) = _pair(8, 4, 0, 5, 0)
    mt = meta.aggregator_meta_information(na, wl.aggregators, 1, 0)
    fn = we.cw2_local_agg_jax if engine == "jax" else we.cw3_shared_jax
    with pytest.raises(NotPortedError, match="queue A item 8"):
        fn(wl, na, mt, [], ntimes=1)


# ---------------------------------------------------------------------------
# the proxy route's tables, delivery and chain

def _reference_tables(wl, na):
    """The reference ``cw_proxy_sim``'s table loops, transcribed verbatim
    (tpu_aggcomm/tam/workload_engines.py:524-575)."""
    n = wl.nprocs
    sizes = wl.msg_size
    aggs = [int(a) for a in wl.aggregators]
    msg_off = {}
    off = 0
    for src in range(n):
        for dst in aggs:
            msg_off[(src, dst)] = off
            off += int(sizes[src])

    def byte_range(start, size):
        return range(start, start + size)

    stage_perm, stage_off, stage_order = [], {}, []
    for node in range(na.nnodes):
        for src in na.local_ranks(node):
            for dst in aggs:
                key = (int(src), dst)
                stage_off[key] = len(stage_perm)
                stage_order.append(key)
                stage_perm.extend(byte_range(msg_off[key], int(sizes[src])))
    exch_perm, exch_off = [], {}
    for node in range(na.nnodes):
        for (src, dst) in stage_order:
            if int(na.node_of[dst]) != node:
                continue
            exch_off[(src, dst)] = len(exch_perm)
            exch_perm.extend(byte_range(stage_off[(src, dst)],
                                        int(sizes[src])))
    recv_perm = []
    for dst in aggs:
        for src in range(n):
            recv_perm.extend(byte_range(exch_off[(src, dst)],
                                        int(sizes[src])))
    return [np.asarray(t, dtype=np.int32)
            for t in (stage_perm, exch_perm, recv_perm)]


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("stripe", STRIPES)
@pytest.mark.parametrize("n,p,kind", TOPOLOGIES + [(64, 8, 0)])
def test_route_tables_equal_the_reference_loops(n, p, kind, stripe,
                                                reorder):
    _, (na, wl) = _pair(n, p, kind, 16, stripe, reorder)
    got = we.proxy_route_tables(wl, na)
    for g, w in zip(got, _reference_tables(wl, na)):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("stripe", STRIPES)
@pytest.mark.parametrize("n,p,kind", [(8, 1, 0), (8, 4, 0), (16, 8, 0),
                                      (7, 3, 0)])
def test_cw_proxy_sim_on_the_cpu_equals_the_reference(n, p, kind, stripe,
                                                      reorder):
    """The port's route on --device cpu and the reference's under JAX on
    the CPU deliver the same bytes; both equal the proxy oracle."""
    (rna, rwl), (na, wl) = _pair(n, p, kind, 5, stripe, reorder)
    want, _ = ref_we.cw_proxy_sim(rwl, rna, ntimes=1)
    got, times = we.cw_proxy_sim(wl, na, ntimes=2, device="cpu")
    _recv_equal(got, want)
    _recv_equal(got, we.cw_proxy(wl, na)[0])
    assert len(times) == 2 and all(t > 0 for t in times)
    flat, _ = we.proxy_route(wl, na, device="cpu")
    assert torch.equal(flat, _flat(wl, want))
    we.verify_recv_flat(wl, flat)


def test_proxy_route_refuses_the_cpu_unasked(monkeypatch):
    from tpu_aggcomm_torch.device import NoCudaDeviceError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, (na, wl) = _pair(8, 4, 0, 5, 0)
    with pytest.raises(NoCudaDeviceError):
        we.proxy_route(wl, na)
    with pytest.raises(SystemExit, match="NoCudaDeviceError"):
        cli.main(["tam", "-n", "8", "--engine", "sim"])


def _scan_transcription(x0: np.ndarray, tables, iters: int) -> np.ndarray:
    """The reference's chained scan body in numpy: three takes, then the
    byte r % 251 XORed in (workload_engines.py:590-607)."""
    x = x0.copy()
    for r in range(iters):
        y = x[tables[0]][tables[1]][tables[2]]
        x = y ^ np.uint8(r % 251)
    return x


@pytest.mark.parametrize("iters", [5, 50, 53])
def test_chain_end_state_equals_the_scan_transcription(iters, monkeypatch):
    """The route's step through the eager chain and through the graph
    chain's block bookkeeping (capture replaced by a direct call) ends
    where the reference's scan body does."""
    _, (na, wl) = _pair(16, 4, 0, 5, 1)
    x0, route, step = we.proxy_route_program(wl, na, "cpu")
    want = _scan_transcription(x0.numpy(), we.proxy_route_tables(wl, na),
                               iters)
    got = chained.eager_chain(None, step=step)(iters)(x0)
    np.testing.assert_array_equal(got.numpy(), want)
    # x0 is the reference's send stream, and the chain left it as it was
    np.testing.assert_array_equal(x0.numpy(), np.concatenate(
        [wl.fill(s, int(g)) for s in range(wl.nprocs)
         for g in wl.aggregators]))
    monkeypatch.setattr(chained, "_capture", lambda fn, state: fn)
    before = len(ledger.compile_records())
    make = chained.graph_chain(None, step=step)
    np.testing.assert_array_equal(make(iters)(x0).numpy(), want)
    np.testing.assert_array_equal(make(iters)(x0).numpy(), want)
    caps = [r["reps"] for r in ledger.compile_records()[before:]
            if r["kind"] == "graph-capture"]
    full, rest = divmod(iters, chained.GRAPH_BLOCK)
    assert sorted(caps) == sorted(([chained.GRAPH_BLOCK] if full else [])
                                  + ([rest] if rest else []))


def test_chained_sim_matches_the_oracle():
    """The chained mode on the CPU: delivery byte-exact, every rep time
    the one differenced per-rep figure; the table build is a ledger
    record."""
    _, (na, wl) = _pair(8, 4, 0, 5, 0)
    before = len(ledger.compile_records())
    recv, times = we.cw_proxy_sim(wl, na, ntimes=3, device="cpu",
                                  chained=True)
    wl.verify_all(recv)
    assert len(times) == 3 and times[0] == times[1] == times[2] > 0
    kinds = [r["kind"] for r in ledger.compile_records()[before:]]
    assert "table-build" in kinds and "compile+warmup" in kinds


# ---------------------------------------------------------------------------
# the vectorised verifier against verify_all

def _corruptions():
    """The reference's mutation tests (tests/test_workload.py:286-330):
    one staged payload's first byte flipped between the hops."""
    def flip(arr):
        arr[0] ^= 0xFF

    def proxy(holdings):
        flip(holdings[0][0][2])

    def nested(staged):
        agg = next(iter(staged))
        src = next(iter(staged[agg]))
        flip(staged[agg][src][next(iter(staged[agg][src]))])

    return [("proxy", 0, 1, proxy), ("local_agg", 1, 2, nested),
            ("shared", 0, 1, nested)]


@pytest.mark.parametrize("engine,stripe,co,hook", _corruptions())
def test_flat_verifier_equals_verify_all(engine, stripe, co, hook):
    na = topology.static_node_assignment(8, 4, 0)
    wl = workload.initialize_setting(na, 5, stripe)
    mt = meta.aggregator_meta_information(na, wl.aggregators,
                                          4 if engine == "shared" else co,
                                          1 if engine == "shared" else 0)
    run = {"proxy": lambda h: we.cw_proxy(wl, na, corrupt_hook=h),
           "local_agg": lambda h: we.cw2_local_agg(wl, na, mt,
                                                   corrupt_hook=h),
           "shared": lambda h: we.cw3_shared(wl, na, mt,
                                             corrupt_hook=h)}[engine]
    good, _ = run(None)
    wl.verify_all(good)
    we.verify_recv_flat(wl, _flat(wl, good))
    bad, _ = run(hook)
    with pytest.raises(VerificationError) as want:
        wl.verify_all(bad)
    with pytest.raises(VerificationError) as got:
        we.verify_recv_flat(wl, _flat(wl, bad))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(6))
def test_flat_verifier_names_the_first_bad_byte(seed):
    """Random flips anywhere in the delivery: the same first (aggregator,
    source, byte) and values as verify_all, under --reorder too."""
    rng = np.random.default_rng(seed)
    _, (na, wl) = _pair(16, 4, 0, 7, seed % 4, reorder=seed % 2 == 1)
    flat, _ = we.proxy_route(wl, na, device="cpu")
    for k in rng.choice(flat.numel(), size=1 + seed % 3, replace=False):
        flat[int(k)] ^= int(rng.integers(1, 256))
    with pytest.raises(VerificationError) as got:
        we.verify_recv_flat(wl, flat)
    with pytest.raises(VerificationError) as want:
        wl.verify_all(we.recv_from_flat(wl, flat.numpy()))
    assert str(got.value) == str(want.value)
    with pytest.raises(VerificationError, match="expected"):
        we.verify_recv_flat(wl, flat[:-1])


# ---------------------------------------------------------------------------
# cli tam against the reference tam

_TIMING = re.compile(r"min rep = [0-9.]+ s")


def _lines(text: str) -> list:
    return [_TIMING.sub("min rep = X s", ln) for ln in text.splitlines()]


@pytest.mark.parametrize("engine", ["proxy", "local_agg", "shared",
                                    "benchmark", "native", "native2",
                                    "native3", "sim"])
@pytest.mark.parametrize("argv", [
    ["-n", "16", "-p", "4", "-b", "16", "-t", "1", "-c", "2", "--mode", "1"],
    ["-n", "12", "-p", "5", "-b", "3", "-t", "0", "-c", "4", "--mode", "1",
     "-r", "1", "-k", "2", "--reorder"],
])
def test_cli_tam_prints_the_reference_lines(engine, argv, capsys):
    """Every line but the timing values is the reference's; the banner
    is byte-identical; sim runs on --device cpu here."""
    assert ref_cli.main(["tam", *argv, "--engine", engine]) == 0
    want = capsys.readouterr().out
    extra = ["--device", "cpu"] if engine == "sim" else []
    assert cli.main(["tam", *argv, "--engine", engine, *extra]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]
    assert _lines(got) == _lines(want)
    assert got.rstrip().endswith("| correctness: PASSED")
