"""Joint multi-dataset MOT training data: video clips + static-image
pseudo-clips mixed into one sampler. The port's copy of fastervit_tpu/
tracking/joint_data.py (reference motrv2/datasets/joint.py), numpy and PIL
only, drawing the same random numbers in the same order.

The reference's DetMOTDetection reads a data_txt spanning several datasets
(MOT17 video frames + CrowdHuman static images) with labels_with_ids files
('class id cx cy w h', normalized), offsets track ids per video
(joint.py:119), and gives static images a per-dataset transform containing
FixedMotRandomShift (transforms.py:338-367) that synthesizes a clip by
cumulatively crop-shifting the single image. Here:

  * `StaticImageClips` — CrowdHuman-style source: each listed image is one
    pseudo-video; clips are cumulative random shift-crops with boxes
    translated/rescaled and zero-area boxes dropped (random_shift,
    transforms.py:71-117);
  * `JointClips` — concatenates any clip sources (DanceTrackClips and/or
    StaticImageClips) behind one index space with the progressive
    clip-length schedule shared across sources, yielding batches in the
    motr_clip_train_epoch format.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ID_OFFSET_PER_VIDEO = 1_000_000


def parse_labels_with_ids(path: str) -> np.ndarray:
    """labels_with_ids file -> (N, 6) rows [class, id, cx, cy, w, h]
    (normalized cxcywh, joint.py:108-116)."""
    if not os.path.isfile(path):
        raise ValueError(f"invalid label path: {path}")
    rows = np.loadtxt(path, dtype=np.float32).reshape(-1, 6)
    return rows


class StaticImageClips:
    """Static-image pseudo-clip source (CrowdHuman in the reference).

    data_txt lists image paths (one per line) relative to seqs_folder;
    labels live at images->labels_with_ids with a .txt extension
    (joint.py:36-42). Each image is its own pseudo-video with a unique
    track-id offset."""

    def __init__(self, data_txt: str, seqs_folder: str = "",
                 shift_padding: int = 50, num_proposals: int = 10,
                 video_offset: int = 0):
        with open(data_txt) as f:
            self.img_files = [os.path.join(seqs_folder, x.strip())
                              for x in f if x.strip()]
        self.label_files = [
            x.replace("images", "labels_with_ids").rsplit(".", 1)[0] + ".txt"
            for x in self.img_files]
        self.shift_padding = shift_padding
        self.num_proposals = num_proposals
        self.video_offset = video_offset

    def __len__(self) -> int:
        return len(self.img_files)

    def load_clip(self, idx: int, rng: np.random.RandomState,
                  image_size: Tuple[int, int], clip_len: int,
                  with_proposals: bool = False):
        """-> (frames (F, H, W, 3) [0,1], targets per frame, proposals) —
        frame 0 is the image, frames 1.. cumulative shift-crops
        (FixedMotRandomShift with bs=1 reuses one sampled shift)."""
        from PIL import Image

        img = Image.open(self.img_files[idx]).convert("RGB")
        w, h = img.size
        rows = parse_labels_with_ids(self.label_files[idx])
        offset = (self.video_offset + idx) * ID_OFFSET_PER_VIDEO
        ids = np.where(rows[:, 1] >= 0, rows[:, 1] + offset,
                       rows[:, 1]).astype(np.int64)
        boxes = rows[:, 2:6].copy()                    # normalized cxcywh

        # one sampled shift reused for every step (transforms.py:349-353)
        xshift = int(self.shift_padding * rng.rand()) + 1
        xshift *= 1 if rng.randn() > 0 else -1
        yshift = int(self.shift_padding * rng.rand()) + 1
        yshift *= 1 if rng.randn() > 0 else -1

        frames, targets = [], []
        cur_img, cur_boxes, cur_ids = img, boxes, ids
        for f in range(clip_len):
            if f > 0:
                cur_img, cur_boxes, cur_ids = self._shift(
                    cur_img, cur_boxes, cur_ids, xshift, yshift)
            out = cur_img.resize((image_size[1], image_size[0]),
                                 Image.BILINEAR)
            frames.append(np.asarray(out, np.float32) / 255.0)
            targets.append({
                "labels": np.zeros(len(cur_boxes), np.int32),
                "boxes": np.asarray(cur_boxes, np.float32).reshape(-1, 4),
                "track_ids": np.asarray(cur_ids, np.int64),
            })
        proposals = None
        if with_proposals:
            proposals = np.tile(
                np.asarray([0.5, 0.5, 0.1, 0.1, 0.0], np.float32),
                (clip_len, self.num_proposals, 1))
        return np.stack(frames), targets, proposals

    def _shift(self, img, boxes_n, ids, xshift: int, yshift: int):
        """random_shift (transforms.py:71-117) in normalized coordinates:
        crop the region shifted by (xshift, yshift), rescale to full size,
        translate boxes, drop those whose clipped area vanishes."""
        w, h = img.size
        ymin, ymax = max(0, -yshift), min(h, h - yshift)
        xmin, xmax = max(0, -xshift), min(w, w - xshift)
        cw, ch = xmax - xmin, ymax - ymin
        out = img.crop((xmin, ymin, xmax, ymax)).resize((w, h))
        if len(boxes_n) == 0:
            return out, boxes_n, ids
        # normalized cxcywh -> pixel xyxy -> crop frame -> normalized cxcywh
        cx, cy, bw, bh = (boxes_n[:, 0] * w, boxes_n[:, 1] * h,
                          boxes_n[:, 2] * w, boxes_n[:, 3] * h)
        x0, y0 = cx - bw / 2 - xmin, cy - bh / 2 - ymin
        x1, y1 = x0 + bw, y0 + bh
        # keep test on the clipped boxes (transforms.py:102-106)
        kx0, ky0 = np.clip(x0, 0, cw), np.clip(y0, 0, ch)
        kx1, ky1 = np.clip(x1, 0, cw), np.clip(y1, 0, ch)
        keep = (kx1 > kx0) & (ky1 > ky0)
        x0, y0, x1, y1 = x0[keep], y0[keep], x1[keep], y1[keep]
        new = np.stack([(x0 + x1) / 2 / cw, (y0 + y1) / 2 / ch,
                        (x1 - x0) / cw, (y1 - y0) / ch], -1)
        return out, new.astype(np.float32), ids[keep]


class JointClips:
    """Concatenated clip sources behind one index space with shared
    progressive clip lengths — the joint.py multi-dataset sampler."""

    def __init__(self, sources: Sequence, clip_len: int = 5,
                 sampler_steps: Optional[Sequence[int]] = None,
                 sampler_lengths: Optional[Sequence[int]] = None):
        self.sources = list(sources)
        self.sampler_steps = list(sampler_steps or [])
        self.lengths = list(sampler_lengths or [clip_len])
        self.num_frames_per_batch = self.lengths[0]
        self.current_epoch = 0
        self._bounds = np.cumsum([0] + [len(s) for s in self.sources])

    def __len__(self) -> int:
        return int(self._bounds[-1])

    def set_epoch(self, epoch: int) -> None:
        self.current_epoch = epoch
        period = 0
        for i, step in enumerate(self.sampler_steps):
            if epoch >= step:
                period = i + 1
        self.num_frames_per_batch = self.lengths[
            min(period, len(self.lengths) - 1)]
        for s in self.sources:
            if hasattr(s, "set_epoch"):
                s.set_epoch(epoch)

    def step_epoch(self) -> None:
        self.set_epoch(self.current_epoch + 1)

    def load_clip(self, idx: int, rng: np.random.RandomState,
                  image_size: Tuple[int, int], with_proposals: bool = False):
        si = int(np.searchsorted(self._bounds, idx, side="right")) - 1
        local = idx - int(self._bounds[si])
        src = self.sources[si]
        if isinstance(src, StaticImageClips):
            return src.load_clip(local, rng, image_size,
                                 self.num_frames_per_batch, with_proposals)
        # video source (DanceTrackClips API)
        src.num_frames_per_batch = self.num_frames_per_batch
        return src.load_clip(local, rng, image_size, with_proposals)

    def clip_batches(self, batch_size: int, rng: np.random.RandomState,
                     image_size: Tuple[int, int],
                     with_proposals: bool = False, shuffle: bool = True):
        """Yield (frames (F,B,H,W,3), targets [frame][image], proposals
        (F,B,P,5)|None) — the motr_clip_train_epoch format. Mixed-source
        batches are the point: clips from every source interleave."""
        order = np.arange(len(self))
        if shuffle:
            rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            clips = [self.load_clip(int(i), rng, image_size, with_proposals)
                     for i in order[s:s + batch_size]]
            frames = np.stack([c[0] for c in clips], axis=1)
            f = frames.shape[0]
            targets = [[c[1][fi] for c in clips] for fi in range(f)]
            props = (np.stack([c[2] for c in clips], axis=1)
                     if with_proposals else None)
            yield frames, targets, props
