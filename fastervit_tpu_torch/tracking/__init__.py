"""MOTR/MOTRv2 tracking: the PyTorch port of fastervit_tpu/tracking's
serving path (the checkpoint-exact MOTRv2 detector and its streaming loop,
the JAX package's own MOTRDetector and its loop, the weights bridge, the
MOT file format and the submit CLI), its clip training (the clip forward,
the clip-consistent matching, the clip train step and epoch, the
DanceTrack and joint readers and the training CLI, `tracking.main`) and
its evaluation suite: TrackEval's metrics (`metrics`: CLEAR, Identity,
HOTA, VACE, track mAP), the benchmark adapters (`benchmarks`: MOT17/20,
DanceTrack, CroHD, KITTI, BDD100K; `mots`: MOTSChallenge, KITTI-MOTS;
`davis`, `robmots`, `tao`, `vis`: YouTube-VIS), the Evaluator and its CLI
(`python -m fastervit_tpu_torch.tracking.evaluator`), MOT-file scoring
(`mot_data.evaluate_mot_files`), the runtime tracker that turns a
detector into a tracker (`tracker`) and the host tools (`tools`: det_db,
tracklet stitching, visualisation). The evaluation modules are numpy and
scipy; the COCO-RLE mask codec they use is `utils/rle.py`."""
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
