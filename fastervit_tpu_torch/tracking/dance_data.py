"""DanceTrack / MOT-layout clip sampling for MOTR training: the port's copy
of fastervit_tpu/tracking/dance_data.py (reference downstream/
object_tracking/motrv2/datasets/dance.py DetMOTDetection), numpy and PIL
only, drawing the same random numbers in the same order.

Semantics: gt.txt parsing with mark==0 and non-person-label filtering
(dance.py:55-65), per-video object-id offsets of 100000 (dance.py:176),
clip start indices over [t_min, t_max - clip_len] (dance.py:80-88),
random-interval frame sampling clamped to the sequence end
(dance.py:222-227), progressive clip lengths over epochs
(sampler_steps/sampler_lengths, dance.py:113-127), and the external
proposal db (det_db json of per-frame "x,y,w,h,score" lines,
dance.py:106-110 + 194-198) that feeds MOTRv2's proposal queries.

Images decode with PIL at load time; everything else is numpy. Boxes are
returned normalized cxcywh (the format the detection criterion consumes);
proposals as (P, 5) normalized cxcywh+score padded to a static count.
Frames are NHWC here; the training CLI moves them to the detector's NCHW.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NON_PERSON_LABELS = {3, 4, 5, 6, 9, 10, 11}   # dance.py:60
ID_OFFSET_PER_VIDEO = 100000                  # dance.py:176


def _parse_gt(gt_path: str) -> Dict[int, List[Tuple[float, float, float,
                                                     float, int]]]:
    """gt.txt rows 'frame,id,x,y,w,h,mark,label,...' -> {frame: [(x,y,w,h,id)]}
    with mark==0 and non-person labels dropped (dance.py:55-65)."""
    per_frame: Dict[int, List] = defaultdict(list)
    with open(gt_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(",")
            t, i = int(parts[0]), int(parts[1])
            x, y, w, h = map(float, parts[2:6])
            mark = int(float(parts[6])) if len(parts) > 6 else 1
            label = int(float(parts[7])) if len(parts) > 7 else 1
            if mark == 0 or label in NON_PERSON_LABELS:
                continue
            per_frame[t].append((x, y, w, h, i))
    return per_frame


class DanceTrackClips:
    """Clip sampler over a MOT-layout root:
    <root>/<split>/<seq>/{gt/gt.txt, img1/%08d.jpg}."""

    def __init__(self, root: str, splits: Sequence[str] = ("train",),
                 clip_len: int = 5, sample_interval: int = 10,
                 sample_mode: str = "random_interval",
                 sampler_steps: Optional[Sequence[int]] = None,
                 sampler_lengths: Optional[Sequence[int]] = None,
                 det_db: Optional[str] = None,
                 num_proposals: int = 10):
        self.root = root
        self.sample_interval = sample_interval
        self.sample_mode = sample_mode
        self.sampler_steps = list(sampler_steps or [])
        self.lengths = list(sampler_lengths or [clip_len])
        self.clip_len = max(self.lengths)
        self.num_proposals = num_proposals

        self.labels_full: Dict[str, Dict[int, List]] = {}
        self.video_dict: Dict[str, int] = {}
        self.vid_tmax: Dict[str, int] = {}
        for split in splits:
            split_dir = os.path.join(root, split)
            if not os.path.isdir(split_dir):
                continue
            for seq in sorted(os.listdir(split_dir)):
                if seq == "seqmap":
                    continue
                vid = os.path.join(split, seq)
                gt_path = os.path.join(root, vid, "gt", "gt.txt")
                if not os.path.exists(gt_path):
                    continue
                self.labels_full[vid] = _parse_gt(gt_path)

        self.indices: List[Tuple[str, int]] = []
        for vid, frames in self.labels_full.items():
            self.video_dict[vid] = len(self.video_dict)
            t_min, t_max = min(frames), max(frames) + 1
            self.vid_tmax[vid] = t_max - 1
            for t in range(t_min, t_max - self.clip_len):
                self.indices.append((vid, t))

        self.det_db: Dict[str, List[str]] = defaultdict(list)
        if det_db:
            with open(os.path.join(root, det_db)) as f:
                self.det_db = defaultdict(list, json.load(f))
        self.period_idx = 0
        self.current_epoch = 0
        self.num_frames_per_batch = self.lengths[0]

    def __len__(self) -> int:
        return len(self.indices)

    # --- progressive clip lengths (dance.py:113-127) --------------------
    def set_epoch(self, epoch: int) -> None:
        self.current_epoch = epoch
        if not self.sampler_steps:
            return
        self.period_idx = 0
        for i, step in enumerate(self.sampler_steps):
            if epoch >= step:
                self.period_idx = i + 1
        self.num_frames_per_batch = self.lengths[
            min(self.period_idx, len(self.lengths) - 1)]

    def step_epoch(self) -> None:
        self.set_epoch(self.current_epoch + 1)

    # --- sampling --------------------------------------------------------
    def sample_frame_indices(self, vid: str, f_index: int,
                             rng: np.random.RandomState) -> List[int]:
        """Random-interval ids clamped to the sequence end
        (dance.py:222-227)."""
        if self.sample_mode == "random_interval":
            rate = rng.randint(1, self.sample_interval + 1)
        else:
            rate = self.sample_interval
        tmax = self.vid_tmax[vid]
        return [min(f_index + rate * i, tmax)
                for i in range(self.num_frames_per_batch)]

    def frame_image_path(self, vid: str, t: int) -> str:
        return os.path.join(self.root, vid, "img1", f"{t:08d}.jpg")

    def frame_targets(self, vid: str, t: int,
                      img_size: Tuple[int, int]) -> Dict[str, np.ndarray]:
        """Targets for one frame: normalized cxcywh boxes, class 0 labels,
        globally unique track ids (dance.py:170-206)."""
        w, h = img_size
        rows = self.labels_full[vid].get(t, [])
        offset = self.video_dict[vid] * ID_OFFSET_PER_VIDEO
        boxes = np.asarray([[x, y, bw, bh] for x, y, bw, bh, _ in rows],
                           np.float32).reshape(-1, 4)
        cxcywh = np.stack([
            (boxes[:, 0] + boxes[:, 2] / 2) / w,
            (boxes[:, 1] + boxes[:, 3] / 2) / h,
            boxes[:, 2] / w, boxes[:, 3] / h], -1) if len(boxes) else \
            np.zeros((0, 4), np.float32)
        return {
            "labels": np.zeros(len(rows), np.int32),
            "boxes": cxcywh,
            "track_ids": np.asarray([i + offset for *_, i in rows], np.int64),
        }

    def frame_proposals(self, vid: str, t: int,
                        img_size: Tuple[int, int]) -> np.ndarray:
        """(num_proposals, 5) normalized cxcywh+score from the det_db,
        zero-score centered padding (dance.py:194-198 + motr.py:468-473)."""
        w, h = img_size
        key = os.path.join(vid, "img1", f"{t:08d}.txt")
        out = np.tile(np.asarray([0.5, 0.5, 0.1, 0.1, 0.0], np.float32),
                      (self.num_proposals, 1))
        rows = []
        for line in self.det_db.get(key, []):
            x, y, bw, bh, s = map(float, line.split(","))
            rows.append([(x + bw / 2) / w, (y + bh / 2) / h, bw / w, bh / h,
                         s])
        rows.sort(key=lambda r: -r[4])
        for i, r in enumerate(rows[:self.num_proposals]):
            out[i] = r
        return out

    def load_clip(self, idx: int, rng: np.random.RandomState,
                  image_size: Optional[Tuple[int, int]] = None,
                  with_proposals: bool = False):
        """-> (frames (F, H, W, 3) float32 in [0,1], targets list of per-frame
        dicts, proposals (F, P, 5) or None). Images resize to image_size
        (h, w) when given."""
        from PIL import Image

        vid, f_index = self.indices[idx]
        frame_ids = self.sample_frame_indices(vid, f_index, rng)
        frames, targets, proposals = [], [], []
        for t in frame_ids:
            img = Image.open(self.frame_image_path(vid, t)).convert("RGB")
            orig_size = img.size                       # (w, h)
            if image_size is not None:
                img = img.resize((image_size[1], image_size[0]),
                                 Image.BILINEAR)
            frames.append(np.asarray(img, np.float32) / 255.0)
            targets.append(self.frame_targets(vid, t, orig_size))
            if with_proposals:
                proposals.append(self.frame_proposals(vid, t, orig_size))
        return (np.stack(frames), targets,
                np.stack(proposals) if with_proposals else None)

    def clip_batches(self, batch_size: int, rng: np.random.RandomState,
                     image_size: Tuple[int, int],
                     with_proposals: bool = False, shuffle: bool = True):
        """Yield (frames (F,B,H,W,3), per-frame-per-image targets,
        proposals (F,B,P,5)|None) batches — the motr_clip_train_epoch
        format."""
        order = np.arange(len(self.indices))
        if shuffle:
            rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            clips = [self.load_clip(int(i), rng, image_size, with_proposals)
                     for i in order[s:s + batch_size]]
            frames = np.stack([c[0] for c in clips], axis=1)   # (F,B,H,W,3)
            f = frames.shape[0]
            targets_per_frame = [[c[1][fi] for c in clips] for fi in range(f)]
            props = (np.stack([c[2] for c in clips], axis=1)
                     if with_proposals else None)
            yield frames, targets_per_frame, props
