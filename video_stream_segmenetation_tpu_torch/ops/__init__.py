"""Plain PyTorch ops of the serving path (ports of ``ops/*``)."""
