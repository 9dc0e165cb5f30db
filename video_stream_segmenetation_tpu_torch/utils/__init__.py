"""Utilities (ports of ``utils/*``): weight quantization."""
