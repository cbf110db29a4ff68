"""Diffusion algebra and noise schedules."""
