"""The port's counterparts of the repository's ``scripts/`` tools, each
under the reference script's file name: ``quality_run`` (the flagship model
trained on a seeded synthetic corpus, with learning curves),
``analyze_training_regression`` (offline forensics of a run directory) and
``e2e_audio_artifact`` (a run directory through HiFi-GAN to a WAV).  Run
each as ``python -m kokoro_tpu_torch.scripts.<name>``; their outputs go
under the run directory or ``--out``, never into ``docs/``."""
