"""Bytes-touched roofline model of ``torch_sim``'s rep on one H100.

The port of ``tpu_aggcomm/harness/roofline.py``: the same question (is a
measured per-rep time the HBM floor of its bytes, or multiples off it?)
and the same API (:class:`RepBytes`, :func:`rep_bytes`,
:func:`tam_rep_bytes`, :func:`chain_overhead_bytes`,
:func:`floor_seconds`), priced at the card's own rate and counted from
the program ``torch_sim`` runs (:mod:`tpu_aggcomm_torch.backends.
torch_sim`), not from the XLA program the reference models.

One rep of a round-structured schedule (``TorchSimBackend._one_rep``)
is: ``torch.zeros`` of the recv arena, then for each round
``recv[dsts, ds_] = send[srcs, ss]`` (advanced indexing: a gather into a
temporary, then an ``index_put_`` of it), then the round's barrier
tokens. It touches:

- ``gather_read``   — every payload edge's row read from the send arena
  (E * d), as the reference counts it;
- ``scatter_write`` — the same bytes landed in the recv arena (E * d), as
  the reference;
- ``zero_init``     — the recv arena, trash row included, zeroed once a
  rep (n * (R + 1) * d), as the reference;
- ``intermediate``  — the temporaries the program materializes between a
  gather and its scatter: one write and one read of every gathered row
  (2 * d an entry). The reference counts none for ``jax_sim`` (XLA fuses
  the gather into the scatter); PyTorch's indexing cannot. The dense
  collectives (m=5/8) materialize two (n, n) row blocks (the gather and
  its masked product), the TAM route its staged and exchanged slab
  arrays, a relay hop of a dead-link repair the staging rows it reads
  from recv;
- ``refence_walks`` — zero. In the reference it is the recv-arena copy an
  XLA fence may force between fenced rounds. Here every round is its own
  launches on one stream, updating one arena in place: the launch
  boundary orders the rounds and copies nothing. So the port's fenced
  floor equals its optimistic one; the per-launch cost of those
  boundaries is time, not bytes, and is not in any floor;
- ``index_read``    — new: the int64 index tables each indexing launch
  reads, 8 bytes an entry and table (four tables a round: ``srcs``,
  ``ss`` for the gather, ``dsts``, ``ds_`` for the scatter);
- ``barrier``       — new: a barrier token reads every rank's recv lane 0
  (n * R lanes), widens it to an int64 temporary (written and read), sums
  it, and writes the token into each rank's trash row lane 0;
- ``pad``           — new: rows moved that carry no payload. Under the
  padded-table lowering (``_scan_lowered``: at least 32 rounds, at most
  one barrier a round) a pad entry gathers ``send[0, 0]`` into rank 0's
  trash row; the dense collectives read and write all n * n rows of
  their exchange, of which only E carry payload. Each such row is
  counted read and written, as the program issues it.

Fault-injected schedules are priced as the faulted lowering
(``_one_rep_faulted``) runs them: the masked extended edge table, relay
staging rows in the recv arena. The reference prices dead-link-repaired
schedules not at all (its edge table refuses relay staging); the
slow-rank delay loop is latency-bound work, not bytes, and is in no
floor.

:func:`chain_overhead_bytes` is the chained scaffold's extra a rep
(``harness/chained.chain_step``): the XOR reads and writes the whole send
arena, and the token reads only every rank's recv lane 0. The reference
counts the whole recv arena for its checksum.

TAM (:func:`tam_rep_bytes`) models ``torch_sim``'s three-hop route
(``_tam_tables``, ``_tam_rep``): the reference's terms, plus the four
index tables; with ``lowering="torch_shard"`` it models the blocked
two-level engine on one device (``tam/engine.tam_two_level_sharded``):
the first hop gathers every slab into a temporary with one zero row, the
second gathers that into another, the scatter lands it in the zeroed
recv arena (three int64 tables). It is not the ``cli tam --engine sim`` route
(``tam/workload_engines.proxy_route``), whose floor is 20 bytes a
delivered byte.

``lowering="torch_shard"`` prices the sharded tier's program
(:mod:`tpu_aggcomm_torch.backends.torch_shard`) as the card runs it.
Over ``ndev`` > 1 devices, under a process group, each device zeroes its
compacted flat recv buffer (F rows, trash row included), and each round
gathers its padded block entries into a temporary (``index.Tensor``) and
lands them (``index_put_``), ``ndev * ndev * M`` entries a round over the
mesh (the widest round's M for every round under the padded-table
lowering). Terms as above, summed over the devices: ``pad`` is the block
padding (and the padded-table rounds'), ``index_read`` the two int64
tables of every entry; each round also masks the gathered blocks (one
read and one write of the temporary, plus the mask: one lane an entry,
in ``index_read``) and the all_to_all reads it and writes the landed
blocks (two more passes, in ``intermediate``). A barrier token is one
lane all-reduced into one lane of the trash row (the reference's
``psum`` of ``recv[0, 0]``), no arena bytes: ``barrier`` is 0. The floor
of a rep over ndev devices is the total over ``ndev`` cards' bandwidth
(``devices``), a lower bound of the busiest card's time.

On one device (``ndev`` 1) a round is one launch of the row-delivery
kernel (:mod:`tpu_aggcomm_torch.backends.deliver_rows`), or a rep of many
barrier-free rounds one launch with its rounds fenced inside, priced from
the rounds and zero runs the backend builds
(``torch_shard.one_device_build``): every edge's row is read once and
written once (``gather_read``, ``scatter_write``); nothing is
materialized between them (``intermediate`` 0); ``zero_init`` is only
the rows the rounds never write, zeroed by the first launch; the kernel
reads two int32 tables an entry and the zero runs' two, and a
many-round launch its round offsets (``index_read``);
a padded round's pads are one entry, send row 0 read and written into
the trash row (``pad``). The chained scaffold adds the XOR of every
device's flat send buffer and the token's read of every live row's
lane 0.

The model imports the backends' table builders, and with them torch,
only when a rep is priced; :func:`floor_seconds` and the constants need
nothing.

Scope: these are HBM floors. A rep whose arenas stay in the 50 MB L2
can beat them; :data:`L2_COPY_H100_GBPS` is the rate such a rep is
bounded by instead.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["RepBytes", "rep_bytes", "tam_rep_bytes",
           "chain_overhead_bytes", "floor_seconds", "HBM_H100_GBPS",
           "L2_COPY_H100_GBPS"]

#: Peak HBM3 bandwidth of one H100 SXM, GB/s (NVIDIA data sheet: 3.35
#: TB/s), the rate of every floor here, on the port's card as nvidia-smi
#: names it with its power limit: "NVIDIA H100 80GB HBM3, 700.00 W".
HBM_H100_GBPS = 3350.0

#: The L2 copy rate of the same card, GB/s moved (read plus write):
#: ``chip_smoke.l2_copy_rate()``, plain ``copy_`` between L2-resident 8
#: and 16 MiB buffers, graph-timed and differenced, measured 4.453 TB/s on
#: "NVIDIA H100 80GB HBM3, 700.00 W". A second figure beside the HBM
#: floors, for reps whose arenas fit in L2.
L2_COPY_H100_GBPS = 4453.0

#: bytes of one int64 index entry
_IDX = 8


@dataclass
class RepBytes:
    """Per-rep bytes-touched breakdown (all plain ints, host-computed);
    the module docstring defines each term."""

    gather_read: int
    scatter_write: int
    zero_init: int
    intermediate: int
    refence_walks: int
    rounds: int
    edges: int
    index_read: int = 0
    barrier: int = 0
    pad: int = 0
    #: cards the bytes spread over (the sharded tier's ndev)
    devices: int = 1

    def total(self, *, fenced: bool = False) -> int:
        t = (self.gather_read + self.scatter_write + self.zero_init
             + self.intermediate + self.index_read + self.barrier
             + self.pad)
        return t + (self.refence_walks if fenced else 0)

    def floor_seconds(self, bandwidth_gbps: float = HBM_H100_GBPS, *,
                      fenced: bool = False) -> float:
        return floor_seconds(self.total(fenced=fenced),
                             bandwidth_gbps * self.devices)


def floor_seconds(nbytes: int, bandwidth_gbps: float = HBM_H100_GBPS
                  ) -> float:
    """Seconds to move ``nbytes`` at ``bandwidth_gbps`` GB/s."""
    return nbytes / (bandwidth_gbps * 1e9)


def _lane_bytes(d: int) -> int:
    """Bytes of one lane of a ``d``-byte row (``backends/lanes``: int32
    lanes when 4-aligned, bytes otherwise)."""
    return 4 if d % 4 == 0 else 1


def _check_lowering(lowering: str, ndev: int) -> None:
    if lowering not in ("torch_sim", "torch_shard"):
        raise ValueError(f"unknown lowering {lowering!r} (the port's "
                         f"lowerings are 'torch_sim', single-device, and "
                         f"'torch_shard')")
    if lowering == "torch_sim" and ndev != 1:
        raise ValueError("torch_sim is single-device by construction")
    if ndev < 1:
        raise ValueError(f"ndev must be >= 1, got {ndev}")


def _shard_layout(p, ndev: int):
    """(bsz, F, Fs) of torch_shard's compacted layouts over ``ndev``."""
    from tpu_aggcomm_torch.backends.torch_shard import (recv_layout,
                                                        send_counts)
    from tpu_aggcomm_torch.harness.verify import recv_slot_counts
    import numpy as np
    bsz = -(-p.nprocs // ndev)
    _, F = recv_layout(np.asarray(recv_slot_counts(p)), ndev, bsz)
    _, Fs = recv_layout(send_counts(p), ndev, bsz)
    return bsz, F, Fs


def _shard_rep_bytes(schedule, ndev: int) -> RepBytes:
    """One rep of ``torch_shard``'s group program over ``ndev`` >= 2
    devices (module docstring)."""
    import numpy as np

    from tpu_aggcomm_torch.backends.torch_shard import (block_round_tables,
                                                        recv_layout,
                                                        schedule_edges,
                                                        send_counts)
    from tpu_aggcomm_torch.core.schedule import barrier_rounds_of
    from tpu_aggcomm_torch.harness.verify import recv_slot_counts

    p = schedule.pattern
    d = p.data_size
    bsz = -(-p.nprocs // ndev)
    recv_base, F = recv_layout(np.asarray(recv_slot_counts(p)), ndev, bsz)
    send_base, _Fs = recv_layout(send_counts(p), ndev, bsz)
    edges = schedule_edges(schedule)
    tabs = block_round_tables(edges, ndev=ndev, bsz=bsz,
                              send_base=send_base, recv_base=recv_base, F=F)
    widths = [m for (_r, _pk, _sc, m) in tabs]
    if len(tabs) >= 32 and not barrier_rounds_of(schedule):
        widths = [max(widths)] * len(widths)     # the padded-table form
    entries = ndev * ndev * sum(widths)
    nedges = len(edges)
    return RepBytes(
        gather_read=nedges * d, scatter_write=nedges * d,
        zero_init=ndev * F * d, intermediate=6 * entries * d,
        refence_walks=0, rounds=max(len(tabs), 1), edges=nedges,
        index_read=entries * (2 * _IDX + _lane_bytes(d)), barrier=0,
        pad=2 * (entries - nedges) * d, devices=ndev)


def _deliver_rep_bytes(schedule) -> RepBytes:
    """One ``torch_shard`` rep on one device: a row-delivery launch a
    round, or one for the rep (module docstring)."""
    from tpu_aggcomm_torch.backends.torch_shard import one_device_build

    d = schedule.pattern.data_size
    built = one_device_build(schedule, "cpu")
    nedges = sum(tab.edges for (_r, tab, _nb) in built.rounds)
    entries = sum(tab.rows.n_rows for (_r, tab, _nb) in built.rounds)
    zero = built.zero
    return RepBytes(
        gather_read=nedges * d, scatter_write=nedges * d,
        zero_init=zero.rows * d, intermediate=0, refence_walks=0,
        rounds=max(len(built.rounds), 1), edges=nedges,
        index_read=8 * entries + (4 * (2 * len(zero.runs) + 1)
                                  if zero.runs else 0)
        + (4 * (len(built.rounds) + 1) if built.fused is not None else 0),
        barrier=0, pad=2 * (entries - nedges) * d, devices=1)


def _barrier_bytes(n: int, n_recv_slots: int, d: int) -> int:
    """One barrier token (``torch_sim._barrier_token`` and its store)."""
    lb = _lane_bytes(d)
    return n * n_recv_slots * (lb + 2 * 8) + n * lb


def rep_bytes(schedule, *, lowering: str = "torch_sim", ndev: int = 1
              ) -> RepBytes:
    """Model one ``torch_sim`` rep of ``schedule``: the round tables as
    they are or padded, the dense collectives' exchange, or the faulted
    lowering, whichever ``TorchSimBackend._one_rep`` runs. TAM schedules
    are modeled by :func:`tam_rep_bytes`."""
    from tpu_aggcomm_torch.harness.verify import slot_shapes
    from tpu_aggcomm_torch.tam.engine import TamMethod

    if isinstance(schedule, TamMethod):
        raise ValueError("TAM reps are modeled by tam_rep_bytes, "
                         "not the rank-axis rep_bytes")
    _check_lowering(lowering, ndev)
    if lowering == "torch_shard":
        return (_deliver_rep_bytes(schedule) if ndev == 1
                else _shard_rep_bytes(schedule, ndev))
    from tpu_aggcomm_torch.backends.torch_sim import (_dense_tables,
                                                      _faulted,
                                                      _faulted_tables,
                                                      _round_tables,
                                                      _scan_lowered)

    p = schedule.pattern
    n, d = p.nprocs, p.data_size
    _, n_recv_slots = slot_shapes(p)

    if schedule.collective:
        _sslot, smask, rslot = _dense_tables(p, n_recv_slots)
        nedges = len(p.senders) * len(p.receivers)
        dense = n * n
        return RepBytes(
            gather_read=nedges * d, scatter_write=nedges * d,
            zero_init=n * (n_recv_slots + 1) * d,
            intermediate=4 * dense * d, refence_walks=0, rounds=1,
            edges=nedges, index_read=_IDX * (len(smask) + len(rslot)),
            pad=2 * (dense - nedges) * d)

    F, staged = n_recv_slots, 0
    if _faulted(schedule):
        rounds, barrier_rounds, F, _slow = _faulted_tables(schedule,
                                                           n_recv_slots)
        tabs = [t[1:5] for t in rounds]
        staged = sum(int(t[5].sum()) for t in rounds)
    else:
        rounds, barrier_rounds = _round_tables(schedule)
        tabs = [t[1:] for t in rounds]
    nbars = sum(barrier_rounds.get(t[0], 0) for t in rounds)
    nedges = sum(len(t[0]) for t in tabs)
    # the padded-table lowering runs every round at the widest round's width
    entries = (len(tabs) * max(len(t[0]) for t in tabs)
               if _scan_lowered(tabs, barrier_rounds) else nedges)
    return RepBytes(
        gather_read=nedges * d, scatter_write=nedges * d,
        zero_init=n * (F + 1) * d,
        intermediate=2 * entries * d + 4 * staged * d,
        refence_walks=0, rounds=max(len(tabs), 1), edges=nedges,
        index_read=_IDX * (4 * entries + 3 * staged),
        barrier=nbars * _barrier_bytes(n, n_recv_slots, d),
        pad=2 * (entries - nedges) * d)


def tam_rep_bytes(tam, *, lowering: str = "torch_sim") -> RepBytes:
    """Model one rep of ``torch_sim``'s single-device 3-hop TAM route
    (``_tam_rep``): the P2 gather reads E send rows into the staged array,
    P3 gathers it into the exchanged array, P4 scatters that into the
    zeroed recv arena. Both arrays are real materializations (one write
    and one read of E rows each), as the reference counts them; the four
    int64 index tables (stage, exchange, destination rank, slot) are the
    port's addition. The measured hop times (``measure_tam_hops``) are
    judged against these floors."""
    from tpu_aggcomm_torch.harness.verify import slot_shapes
    from tpu_aggcomm_torch.tam.engine import TamMethod

    if not isinstance(tam, TamMethod):
        raise ValueError("tam_rep_bytes models TAM schedules; use "
                         "rep_bytes for round-structured/collective ones")
    _check_lowering(lowering, 1)
    if lowering == "torch_shard":
        return _tam_shard_rep_bytes(tam)
    from tpu_aggcomm_torch.backends.torch_sim import _tam_tables

    p = tam.pattern
    d = p.data_size
    stage_idx, exch_idx, dst, slot = _tam_tables(tam)
    E = len(stage_idx)
    assert len(exch_idx) == len(dst) == len(slot) == E
    _, n_recv_slots = slot_shapes(p)
    return RepBytes(gather_read=E * d, scatter_write=E * d,
                    zero_init=p.nprocs * (n_recv_slots + 1) * d,
                    intermediate=2 * 2 * E * d, refence_walks=0, rounds=3,
                    edges=E, index_read=_IDX * 4 * E)


def _tam_blocked_rows(tam) -> tuple[int, int, int]:
    """(slabs E, send arena rows S, recv rows R) of the blocked engine on
    one device: every slab in one (1, 1) block, the arenas padded to the
    (nodes x max ranks-per-node) grid."""
    import numpy as np

    from tpu_aggcomm_torch.core.pattern import Direction
    p = tam.pattern
    sizes = np.asarray(tam.assignment.node_sizes)
    slots = len(sizes) * int(sizes.max())
    E = p.nprocs * p.cb_nodes
    if p.direction is Direction.ALL_TO_MANY:
        return E, slots * p.cb_nodes, p.cb_nodes * p.nprocs
    return E, p.cb_nodes * p.nprocs, slots * p.cb_nodes


def _tam_shard_rep_bytes(tam) -> RepBytes:
    """One rep of the blocked two-level engine on one device (the
    docstring's hops): two gathers through temporaries, one scatter."""
    d = tam.pattern.data_size
    E, _S, R = _tam_blocked_rows(tam)
    return RepBytes(gather_read=E * d, scatter_write=E * d,
                    zero_init=(R + 1) * d + d, intermediate=4 * E * d,
                    refence_walks=0, rounds=2, edges=E,
                    index_read=3 * _IDX * E)


def chain_overhead_bytes(schedule, *, lowering: str = "torch_sim",
                         ndev: int = 1) -> int:
    """Extra bytes per rep added by the chained-measurement scaffold
    (``harness/chained.chain_step``): the XOR reads and writes the whole
    send arena, the token reads every rank's recv lane 0 (on
    ``torch_shard``: every device's flat send buffer, and lane 0 of every
    row of its flat recv buffer but the trash row)."""
    from tpu_aggcomm_torch.harness.verify import slot_shapes

    _check_lowering(lowering, ndev)
    p = schedule.pattern
    from tpu_aggcomm_torch.tam.engine import TamMethod
    if lowering == "torch_shard" and isinstance(schedule, TamMethod):
        if ndev != 1:
            raise ValueError("the blocked TAM engine's chain is modeled "
                             "on one device")
        _E, S, R = _tam_blocked_rows(schedule)
        return 2 * (S + 1) * p.data_size + R * _lane_bytes(p.data_size)
    if lowering == "torch_shard":
        _bsz, F, Fs = _shard_layout(p, ndev)
        return ndev * (2 * Fs * p.data_size
                       + (F - 1) * _lane_bytes(p.data_size))
    n_send_slots, n_recv_slots = slot_shapes(p)
    send_arena = p.nprocs * n_send_slots * p.data_size
    return (2 * send_arena
            + p.nprocs * n_recv_slots * _lane_bytes(p.data_size))
