"""Host-side tracking utilities (reference motrv2/tools/).

* build_det_db    — proposal-file sweep into one det_db json
                    (tools/make_detdb.py:13-47, generic roots instead of the
                    hard-coded dataset paths)
* merge_tracklets — union-find tracklet stitching with ambiguity guards
                    (tools/merge_dance_tracklets.py:20-59)
* visualize_tracks — per-frame box/id overlays (tools/visualize.py:15-45's
                    drawing loop; PIL instead of cv2+ffmpeg, optional ffmpeg
                    assembly if present)

The port's copy of fastervit_tpu/tracking/tools.py: the same names,
signatures and code, importing nothing of the JAX package.
"""
from __future__ import annotations

import glob as _glob
import json
import os
import shutil
import subprocess
from collections import defaultdict
from typing import Dict, List, Optional, Sequence


def build_det_db(roots: Sequence[str], output: Optional[str] = None,
                 pattern: str = "*.txt") -> Dict[str, List[str]]:
    """Sweep proposal .txt files under each root into {path: [lines]} —
    the det_db consumed by the MOTRv2 proposal pipeline
    (reference tools/make_detdb.py, submit_dance.py det_db use)."""
    det_db: Dict[str, List[str]] = {}
    for root in roots:
        for file in sorted(_glob.glob(os.path.join(root, "**", pattern),
                                      recursive=True)):
            with open(file) as f:
                det_db[file] = list(f)
    if output:
        with open(output, "w") as f:
            json.dump(det_db, f)
    return det_db


class _UnionFind(dict):
    """Reference FindUnionSet (merge_dance_tracklets.py:20-26)."""

    def find(self, src):
        while src in self:
            src = self[src]
        return src

    def merge(self, dst, src):
        self[self.find(src)] = self.find(dst)


def merge_tracklets(lines: Sequence[str], t_min: int = 20,
                    t_max: int = 100) -> List[str]:
    """Stitch tracklets whose temporal gap is in (t_min, t_max), skipping
    merges where more than one candidate tracklet ends (or starts) within
    t_max of the junction — the reference's ambiguity guard
    (merge_dance_tracklets.py:33-52). Lines are MOT rows
    'frame,id,...'; returns rewritten lines."""
    instance_timestamps = defaultdict(list)
    for line in lines:
        f_id, tid = map(int, line.split(",")[:2])
        instance_timestamps[tid].append(f_id)
    instances = list(instance_timestamps.keys())
    fid_map = _UnionFind()
    for i in instances:
        for j in instances:
            if fid_map.find(i) == fid_map.find(j):
                continue
            end_t = max(instance_timestamps[i])
            start_t = min(instance_timestamps[j])
            if sum(0 <= start_t - max(pts) < t_max
                   for pts in instance_timestamps.values()) > 1:
                continue
            if sum(0 <= min(pts) - end_t < t_max
                   for pts in instance_timestamps.values()) > 1:
                continue
            if t_min < start_t - end_t < t_max:
                fid_map.merge(i, j)
    out = []
    for line in lines:
        f_id, tid, *info = line.split(",")
        out.append(",".join([f_id, str(fid_map.find(int(tid))), *info]))
    return out


def merge_tracklet_dir(input_dir: str, output_dir: str, t_min: int = 20,
                       t_max: int = 100) -> None:
    """Directory form (reference CLI): each per-sequence result file in
    input_dir is stitched into output_dir/tracker/<seq>."""
    os.makedirs(os.path.join(output_dir, "tracker"), exist_ok=True)
    for seq in sorted(os.listdir(input_dir)):
        with open(os.path.join(input_dir, seq)) as f:
            lines = f.readlines()
        merged = merge_tracklets(lines, t_min=t_min, t_max=t_max)
        with open(os.path.join(output_dir, "tracker", seq), "w") as f:
            f.writelines(merged)


def _id_color(i: int):
    # reference get_color (visualize.py:15-16)
    return tuple((i * 23 * j + 43) % 255 for j in range(3))


def visualize_tracks(trk_path: str, img_list: Sequence[str],
                     output_dir: str, det_db: Optional[dict] = None,
                     make_video: bool = False, fps: int = 20) -> List[str]:
    """Draw per-frame track boxes/ids (and optional proposal boxes) onto the
    frames; writes annotated JPEGs to output_dir and optionally assembles an
    mp4 when ffmpeg is available. Returns the written frame paths."""
    from PIL import Image, ImageDraw

    tracklets = defaultdict(list)
    for line in open(trk_path):
        parts = line.split(",")
        t, tid = int(parts[0]), int(parts[1])
        x, y, w, h = map(float, parts[2:6])
        tracklets[t].append((tid, x, y, x + w, y + h))

    os.makedirs(output_dir, exist_ok=True)
    written = []
    for i, path in enumerate(img_list, start=1):
        img = Image.open(path).convert("RGB")
        draw = ImageDraw.Draw(img)
        if det_db is not None:
            key = os.path.splitext(path)[0] + ".txt"
            for line in det_db.get(key, []):
                x, y, w, h, _ = map(float, line.split(","))
                draw.rectangle([x, y, x + w, y + h], outline=(255, 255, 255),
                               width=1)
            # fall through: tracks drawn on top
        for tid, x0, y0, x1, y1 in tracklets.get(i, []):
            c = _id_color(tid)
            draw.rectangle([x0, y0, x1, y1], outline=c, width=2)
            draw.text((x0, max(0.0, y0 - 12)), str(tid), fill=c)
        out = os.path.join(output_dir, f"{i:08d}.jpg")
        img.save(out, quality=90)
        written.append(out)

    if make_video and shutil.which("ffmpeg"):
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(fps), "-i",
             os.path.join(output_dir, "%08d.jpg"), "-pix_fmt", "yuv420p",
             "-loglevel", "error", os.path.join(output_dir, "video.mp4")],
            check=False)
    return written
