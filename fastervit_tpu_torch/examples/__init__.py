"""The port's copies of the repo's examples: `detect` (a DINO detector on
synthetic data: inference, post-processing and one training epoch) and
`track` (a detector's boxes run through the runtime tracker into a MOT
file). Run each with `python -m fastervit_tpu_torch.examples.<name>`."""
