"""Seeded send payloads, made on the device in blocks of senders.

Arena ``arena`` of a run with seed ``seed`` is ``(senders, receivers,
bytes)`` uniform random bytes. It is made block by block: every block
holds a fixed number of senders (:func:`block_rows`, from the shape
alone) and draws from its own generator, seeded from ``(seed, arena,
block)``. So a block can be made again alone, which is how the
reference regenerates what the program was handed.
"""

from __future__ import annotations

import hashlib

import torch

#: about this many bytes a block
BLOCK_BYTES = 1 << 26


def block_rows(nreceivers: int, data_size: int) -> int:
    """Senders a block: the most whose slabs fit in :data:`BLOCK_BYTES`."""
    return max(1, BLOCK_BYTES // (nreceivers * data_size))


def block_seed(seed: int, arena: int, block: int) -> int:
    """A generator seed for one block, below 2**63, from any integer
    ``seed`` (negative or wider than 64 bits too)."""
    digest = hashlib.blake2b(f"{seed}/{arena}/{block}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def blocks(seed: int, arena: int, nsenders: int, nreceivers: int,
           data_size: int, device):
    """Yield ``(i0, i1, block)``: senders ``i0:i1`` of the arena as a
    fresh ``(i1 - i0, nreceivers, data_size)`` uint8 tensor."""
    rows = block_rows(nreceivers, data_size)
    gen = torch.Generator(device=device)
    for b, i0 in enumerate(range(0, nsenders, rows)):
        i1 = min(nsenders, i0 + rows)
        gen.manual_seed(block_seed(seed, arena, b))
        block = torch.empty((i1 - i0, nreceivers, data_size),
                            dtype=torch.uint8, device=device)
        yield i0, i1, block.random_(0, 256, generator=gen)
