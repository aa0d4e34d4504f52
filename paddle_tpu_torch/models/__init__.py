"""Models of the port (counterpart of `paddle_tpu/models/`): the
Transformer (`transformer`: the decoder, inference and training
programs) and DeepFM (`deepfm`)."""
