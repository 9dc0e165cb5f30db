"""Training of the matting nets (port of ``train/``): the losses, the step
with its optimizer, the loop with its synthetic data, and the flagship
trainer (``python -m video_stream_segmenetation_tpu_torch.train.flagship``)."""
