"""Host-side text and audio helpers: Russian G2P, phoneme-sequence assembly,
wav writing."""
