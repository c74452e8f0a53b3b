"""Model configuration, layers, the Mamba-2 mixer and the decoder stack."""
