"""Inversion, edits and reverse-diffusion sampling."""
