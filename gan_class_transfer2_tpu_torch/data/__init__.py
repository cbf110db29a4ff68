"""Input pipeline of the port (the HBM-resident uint8 pool and its on-device augment)."""
