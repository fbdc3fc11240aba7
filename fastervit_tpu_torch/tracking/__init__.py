"""MOTR/MOTRv2 tracking: the PyTorch port of fastervit_tpu/tracking's
serving path (the checkpoint-exact MOTRv2 detector and its streaming loop,
the JAX package's own MOTRDetector and its loop, the weights bridge, the
MOT file format and the submit CLI) and its clip training (the clip
forward, the clip-consistent matching, the clip train step and epoch, the
DanceTrack and joint readers and the training CLI, `tracking.main`)."""
from fastervit_tpu_torch.tracking.motr import (clip_assignments,
                                               clip_matcher_loss,
                                               create_motr_optimizer,
                                               make_motr_clip_train_step,
                                               motr_clip_forward,
                                               motr_clip_loss,
                                               motr_clip_train_epoch)

__all__ = ["clip_assignments", "clip_matcher_loss", "create_motr_optimizer",
           "make_motr_clip_train_step", "motr_clip_forward",
           "motr_clip_loss", "motr_clip_train_epoch"]
