"""Serving: the multi-stream Engine and its counters (ports of ``service/*``)."""
