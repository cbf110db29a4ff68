"""Training of the port (the diffusion train step; the runner comes later)."""
