"""The port's counterparts of the repository's ``scripts/`` tools, each
under the reference script's file name:

* training and its analysis: ``quality_run`` (the flagship model trained on a
  seeded synthetic corpus, with learning curves),
  ``analyze_training_regression`` (offline forensics of a run directory),
  ``e2e_audio_artifact`` (a run directory through HiFi-GAN to a WAV);
* the vocoder's training path: ``train_hifigan`` (HiFi-GAN V1 trained as a
  mel inverter on the synthetic corpus) and ``quantize_hifigan`` (its int8
  export and what it costs);
* benchmarks: ``bench_serving`` (the HTTP server under concurrent clients),
  ``bench_batched_decode`` (AR decode throughput against streams),
  ``bench_step_shapes`` (the training step over batch x length);
* checks: ``examples_validation`` (the README's train-and-speak example),
  ``verify_setup`` (packages, CUDA devices, compilers, MFA, a corpus), and
  the host tools ``check_phoneme_coverage``, ``check_split_lengths``,
  ``warmup_summary`` and ``stochastic_depth_summary``.

Run each as ``python -m kokoro_tpu_torch.scripts.<name>``, on the card unless
``--device cpu`` is given; outputs go under ``--out`` / ``--metrics`` or the
run directory, never into ``docs/``.  The H100 results committed beside them
are ``*_h100.json``."""
