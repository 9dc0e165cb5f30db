"""Runnable examples of the port (``python -m
video_stream_segmenetation_tpu_torch.examples.<name>``)."""
