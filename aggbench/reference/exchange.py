"""The reference exchange and the comparison that decides ``correct``.

The slab that sender ``i`` addresses to receiver ``k`` must arrive at
``recv[k, i]`` (:mod:`.roles`): the expected receive arena is the send
arena transposed in its first two axes. The comparison works in blocks
of senders, regenerating each block of the send arena from the seed
(:func:`aggbench.payload.blocks`), so it never holds a second copy of a
full arena and never reads the arena the program was handed.
"""

from __future__ import annotations

import torch

from aggbench.payload import blocks


def wrong_slabs(recv: torch.Tensor, seed: int, arena: int, nsenders: int,
                nreceivers: int, data_size: int) -> int:
    """How many slabs of ``recv`` (receivers, senders, bytes; uint8)
    differ from what arena ``arena`` of ``seed`` must deliver. Counted on
    ``recv``'s device."""
    if tuple(recv.shape) != (nreceivers, nsenders, data_size):
        raise ValueError(f"receive view {tuple(recv.shape)} is not "
                         f"{(nreceivers, nsenders, data_size)}")
    bad = 0
    for i0, i1, block in blocks(seed, arena, nsenders, nreceivers,
                                data_size, recv.device):
        expected = block.transpose(0, 1)
        bad += int((recv[:, i0:i1] != expected).any(dim=-1).sum())
    return bad


def exchange(send: torch.Tensor) -> torch.Tensor:
    """The plain exchange: ``(senders, receivers, bytes)`` in,
    ``(receivers, senders, bytes)`` out."""
    return send.transpose(0, 1).contiguous()
