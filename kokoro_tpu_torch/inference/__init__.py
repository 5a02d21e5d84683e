"""Inference: the vocoder and the text-to-speech pipeline."""
