"""Schedules and the params checkpoint. The train step is still to be ported
(ROADMAP.md)."""
