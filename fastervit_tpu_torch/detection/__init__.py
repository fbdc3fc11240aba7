"""DINO detection on the FasterViT pyramid backbone (PyTorch port of
fastervit_tpu/detection): the detector and its transformer, the weights
bridge and checkpoint loader, the numpy COCO evaluator and the CLI's
evaluation path."""
