"""``filled_empty``: a fixture under which ``torch.empty`` hands back
filled memory (int32 lanes read 2**31 - 1, byte lanes 255: torch's
deterministic mode), so a receive row that a rep's zero runs miss shows
as wrong bytes. The mode is restored after the test."""

import pytest
import torch


@pytest.fixture
def filled_empty():
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    assert torch.utils.deterministic.fill_uninitialized_memory
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
