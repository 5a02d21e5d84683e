"""Model layer: transformer blocks, variance adaptor, the Kokoro acoustic
model, the autoregressive generator and the HiFi-GAN vocoder, as
``torch.nn.Module``s."""
