"""Training (port of ``train/`` and of the trainers under ``tools/``): the
losses, the step with its optimizer, the loop with its synthetic data, the
face scenes and losses (``face.py``), the articulated people
(``person.py``), the photo-background batches (``realdata.py``), and the
trainers, each run as ``python -m video_stream_segmenetation_tpu_torch.
train.<name>``: ``flagship`` (the MatteNetHD plans and the MatteNet),
``face_trainer`` (the FaceFinder and the LandmarkNet), ``variants`` (the
recurrent, saliency and K-class nets), ``realbg`` (the photo-background
fine-tunes; their quality gates are the package's ``evaluate``)."""
