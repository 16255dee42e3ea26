"""The tuned-schedule cache's manifest fingerprint, the lens a resumed
sweep uses to tell its environment from the one that recorded a cell.
The tuner itself is not ported yet (ROADMAP.md, queue A)."""
