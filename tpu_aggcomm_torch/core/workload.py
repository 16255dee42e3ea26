"""Synthetic variable-size workloads (``initialize_setting`` analog).

The reference's TAM debug harness drives its engines with four synthetic
I/O workloads (``initialize_setting``, lustre_driver_test.c:447-549) named
after Lustre OST-stripe regimes.  Each workload picks a *destination /
aggregator set* and gives every rank a **variable-size** message for every
destination: ``1 + src % blocklen`` bytes (l_d_t.c:471 and siblings) —
unlike the benchmark driver's uniform ``span=1`` slabs, message size varies
per sender.  Payload bytes are the TAM deterministic fill
``MAP_DATA(a,b,c) = 1 + 3a + 5b + 7c`` keyed by (sender rank, receiver
rank, byte offset) (l_d_t.c:20, fill at 474-476 etc.), and the checker is
``test_correctness`` (l_d_t.c:46-58).

Aggregator sets per stripe type (l_d_t.c:10-13, 455-546):

- ``SAME``    (0): the node proxies (``global_receivers``) — one OST per node.
- ``GREATER`` (1): the odd ranks (``2i + 1``) — more OSTs than nodes.
- ``LESS``    (2): the first ``nprocs // 2`` ranks.
- ``ALL``     (3): every rank.

The reference materialises per-rank ``send_size/recv_size/send_buf/recv_buf``
arrays; here the workload is a small immutable description and buffers are
derived on demand (sizes are pure functions of rank, which is also what lets
the TPU engines compile them into static index maps).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from tpu_aggcomm_torch.core.topology import NodeAssignment
from tpu_aggcomm_torch.harness.verify import VerificationError, fill_slab_tam

__all__ = ["StripeType", "Workload", "initialize_setting"]


class StripeType(enum.IntEnum):
    """OST-stripe regime (lustre_driver_test.c:10-13)."""

    SAME = 0
    GREATER = 1
    LESS = 2
    ALL = 3


@dataclass(frozen=True)
class Workload:
    """A variable-size all-to-aggregators exchange.

    ``msg_size[src]`` bytes flow from every rank ``src`` to every rank in
    ``aggregators``; payload byte ``j`` of the (src → dst) message is
    ``MAP_DATA(src, dst, j)``.  Mirrors the *global* content of the
    reference's per-rank ``send_size/recv_size/send_buf/recv_buf`` outputs
    (l_d_t.c:447-549).
    """

    nprocs: int
    blocklen: int
    stripe: StripeType
    aggregators: np.ndarray = field(repr=False)  # destination ranks; order =
    # file-domain order (ascending from initialize_setting; node-interleaved
    # after reorder_ranklist — engines must not assume sortedness)

    def __post_init__(self):
        if self.blocklen < 1:
            raise ValueError("blocklen must be >= 1")
        a = np.asarray(self.aggregators, dtype=np.int64)
        if len(a) == 0:
            raise ValueError("workload has no aggregators")
        if a.min() < 0 or a.max() >= self.nprocs:
            raise ValueError("aggregator rank out of range")
        object.__setattr__(self, "aggregators", a)

    # -- sizes ------------------------------------------------------------

    @property
    def msg_size(self) -> np.ndarray:
        """Per-sender message size: ``1 + src % blocklen`` (l_d_t.c:471)."""
        return 1 + np.arange(self.nprocs, dtype=np.int64) % self.blocklen

    @property
    def max_msg_size(self) -> int:
        return int(min(self.blocklen, self.nprocs))

    @property
    def is_aggregator(self) -> np.ndarray:
        mask = np.zeros(self.nprocs, dtype=bool)
        mask[self.aggregators] = True
        return mask

    def send_size(self, rank: int) -> np.ndarray:
        """``send_size`` array of ``rank`` (size nprocs, 0 for non-dests)."""
        out = np.zeros(self.nprocs, dtype=np.int64)
        out[self.aggregators] = int(self.msg_size[rank])
        return out

    def recv_size(self, rank: int) -> np.ndarray:
        """``recv_size`` array of ``rank`` (all zeros unless aggregator)."""
        if not self.is_aggregator[rank]:
            return np.zeros(self.nprocs, dtype=np.int64)
        return self.msg_size.copy()

    @property
    def total_bytes(self) -> int:
        return int(self.msg_size.sum()) * len(self.aggregators)

    # -- payload ----------------------------------------------------------

    def fill(self, src: int, dst: int) -> np.ndarray:
        """The (src → dst) message: MAP_DATA(src, dst, j) for j < size(src)."""
        return fill_slab_tam(src, dst, int(self.msg_size[src]))

    def make_send_bufs(self, rank: int) -> list[np.ndarray | None]:
        """``send_buf`` of ``rank``: slot dst = message for dst (or None)."""
        out: list[np.ndarray | None] = [None] * self.nprocs
        for dst in self.aggregators:
            out[int(dst)] = self.fill(rank, int(dst))
        return out

    def alloc_recv_bufs(self, rank: int) -> list[np.ndarray | None]:
        """``recv_buf`` of ``rank``: zeroed slot per source (or all None)."""
        if not self.is_aggregator[rank]:
            return [None] * self.nprocs
        return [np.zeros(int(s), dtype=np.uint8) for s in self.msg_size]

    # -- verification (test_correctness, l_d_t.c:46-58) --------------------

    def verify_recv(self, rank: int, recv_bufs: list[np.ndarray | None]) -> None:
        """Check rank's delivered ``recv_buf`` against the deterministic
        fill; raise :class:`VerificationError` on the first mismatch."""
        if not self.is_aggregator[rank]:
            return
        for src in range(self.nprocs):
            exp = self.fill(src, rank)
            got = recv_bufs[src]
            if got is None or len(got) != len(exp):
                raise VerificationError(
                    f"aggregator {rank}: recv from {src} has size "
                    f"{0 if got is None else len(got)}, expected {len(exp)}")
            if not np.array_equal(np.asarray(got, dtype=np.uint8), exp):
                j = int(np.nonzero(np.asarray(got) != exp)[0][0])
                raise VerificationError(
                    f"unexpected result at aggregator {rank} from {src}: "
                    f"byte {j}: {int(got[j])} != {int(exp[j])}")

    def verify_all(self, recv_by_rank: dict[int, list[np.ndarray | None]]) -> None:
        for rank in self.aggregators:
            self.verify_recv(int(rank), recv_by_rank[int(rank)])


def initialize_setting(assignment: NodeAssignment, blocklen: int,
                       stripe: StripeType | int) -> Workload:
    """Build one of the four synthetic workloads (l_d_t.c:447-549).

    ``assignment`` supplies the node proxies that the SAME regime uses as
    its destination set (the reference passes ``global_receivers`` — the
    per-node proxy list from static_node_assignment / gather_node_information).
    """
    stripe = StripeType(stripe)
    n = assignment.nprocs
    if stripe is StripeType.SAME:
        aggs = np.asarray(assignment.proxies, dtype=np.int64)
    elif stripe is StripeType.GREATER:
        aggs = 2 * np.arange(n // 2, dtype=np.int64) + 1
    elif stripe is StripeType.LESS:
        aggs = np.arange(n // 2, dtype=np.int64)
    else:
        aggs = np.arange(n, dtype=np.int64)
    if len(aggs) == 0:  # n == 1 degenerate GREATER/LESS
        aggs = np.array([0], dtype=np.int64)
    return Workload(nprocs=n, blocklen=int(blocklen), stripe=stripe,
                    aggregators=np.sort(aggs))
