"""Backend adapters: one file a backend, ``backends/<backend>.py``, found
by the ``backend`` of a traffic file.

An adapter module defines ``Adapter(config, traffic, roles, device)``
with:

- ``library()``: load or build what the backend needs before its tables
  (a kernel library), or nothing;
- ``build()``: the schedule and the backend's first build of its rep;
  afterwards ``rep(arena) -> out`` is the exchange the window drives;
- ``new_send()``: a zeroed send arena in the backend's layout;
- ``put_send(arena, i0, i1, block)``: write senders ``i0:i1`` of the
  benchmark's ``(senders, receivers, bytes)`` payload into it;
- ``recv_view(out)``: what ``out`` delivered, as ``(receivers, senders,
  bytes)`` uint8, receivers and senders in :class:`~aggbench.reference.
  roles.Roles` order;
- ``stray_bytes(out)``: non-zero bytes in rows of ``out`` that belong to
  no receiver's slot;
- ``health()``: the backend's own fault records after the window, each
  a count whose limit is 0;
- ``close()``: drop the program's state.
"""
