"""Models of the serving path (ports of ``models/*``)."""
