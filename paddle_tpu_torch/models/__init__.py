"""Models of the port (counterpart of `paddle_tpu/models/`); this slice
holds the Transformer's incremental decoder."""
