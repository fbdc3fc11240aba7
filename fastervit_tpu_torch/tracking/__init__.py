"""MOTR/MOTRv2 streaming tracking: the PyTorch port of
fastervit_tpu/tracking's serving path (the checkpoint-exact MOTRv2
detector and its streaming loop, the JAX package's own MOTRDetector and
its loop, the weights bridge, the MOT file format and the submit CLI)."""
