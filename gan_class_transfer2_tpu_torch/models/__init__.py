"""The Denoiser U-Net."""
