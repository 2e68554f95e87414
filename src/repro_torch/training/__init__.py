"""Training stack of the port: AdamW, the token pipeline, checkpoints and
the fault-tolerant train loop."""
