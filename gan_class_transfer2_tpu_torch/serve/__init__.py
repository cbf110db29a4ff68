"""HTTP serving over a checkpoint (threaded and asyncio frontends) — counterpart
of gan_class_transfer2_tpu/serve."""
