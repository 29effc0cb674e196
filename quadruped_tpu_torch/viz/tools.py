"""Offline video utilities, the port's copy of quadruped_tpu/viz/tools.py.

  * timelapse: concatenate training MP4s with frame decimation
    (makeVideo.py:5-63 create_timelapse_opencv)
  * trim_videos: batch head-trimming of MP4s
    (cutVideo.py:23-86 trim_videos_in_folder; moviepy-free, pure OpenCV)
  * preview_initial_pose: render the reset pose to PNG — the reference's
    preview_initial_pose.py crashes on a missing import
    (go1_standing_env, preview_initial_pose.py:4); this one works
  * view_model: interactive MJCF viewer launch
    (test_scripts/mujoco_model_visualizer.py)

Usage: python -m quadruped_tpu_torch.viz.tools {timelapse,trim,preview,view} ...
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def timelapse(video_dir, out_path="timelapse.mp4", speed_factor: int = 10,
              fps: int = 30) -> str:
    """Concatenate all MP4s in `video_dir` keeping every Nth frame."""
    import cv2

    files = sorted(Path(video_dir).glob("*.mp4"))
    if not files:
        raise FileNotFoundError(f"no .mp4 files in {video_dir}")
    writer = None
    kept = 0
    for f in files:
        cap = cv2.VideoCapture(str(f))
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx % speed_factor == 0:
                if writer is None:
                    h, w = frame.shape[:2]
                    writer = cv2.VideoWriter(
                        str(out_path), cv2.VideoWriter_fourcc(*"mp4v"),
                        fps, (w, h),
                    )
                writer.write(frame)
                kept += 1
            idx += 1
        cap.release()
    if writer:
        writer.release()
    print(f"timelapse: {len(files)} videos -> {kept} frames -> {out_path}")
    return str(out_path)


def trim_videos(folder, seconds_from_start: float, out_folder=None,
                suffix="_trimmed") -> list[str]:
    """Drop the first `seconds_from_start` of every MP4 in `folder`."""
    import cv2

    folder = Path(folder)
    out_folder = Path(out_folder) if out_folder else folder
    out_folder.mkdir(parents=True, exist_ok=True)
    outs = []
    for f in sorted(folder.glob("*.mp4")):
        if suffix and f.stem.endswith(suffix):
            continue
        cap = cv2.VideoCapture(str(f))
        fps = cap.get(cv2.CAP_PROP_FPS) or 30
        skip = int(seconds_from_start * fps)
        out = out_folder / f"{f.stem}{suffix}.mp4"
        writer = None
        idx = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if idx >= skip:
                if writer is None:
                    h, w = frame.shape[:2]
                    writer = cv2.VideoWriter(
                        str(out), cv2.VideoWriter_fourcc(*"mp4v"),
                        fps, (w, h),
                    )
                writer.write(frame)
            idx += 1
        cap.release()
        if writer:
            writer.release()
            outs.append(str(out))
    return outs


def preview_initial_pose(ctrl_type="torque", biped=False, fallen=False,
                         out_path="initial_pose.png", seed=0,
                         device="cuda") -> str:
    """Render a reset-model pose to PNG (fixes preview_initial_pose.py);
    the env's reset and the wireframe's fk run on `device`."""
    import torch

    from ..env.config import Go1Config
    from ..env.go1 import Go1Env
    from .render import TrajectoryRenderer

    cfg = Go1Config(ctrl_type=ctrl_type, biped=biped,
                    fallen_start_prob=1.0 if fallen else 0.0)
    env = Go1Env(cfg, device=device)
    gen = torch.Generator(device=env.device).manual_seed(seed)
    state = env.reset(1, gen)
    r = TrajectoryRenderer(ctrl_type, device=env.device)
    frame = r.frame(state.qpos[0].cpu().numpy())
    r.close()
    import cv2

    cv2.imwrite(str(out_path), cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    print(f"initial pose ({'biped' if biped else 'quadruped'}"
          f"{', fallen' if fallen else ''}) -> {out_path}")
    return str(out_path)


def view_model(ctrl_type="torque"):
    """Interactive viewer (needs a display; equivalent of
    test_scripts/mujoco_model_visualizer.py)."""
    import mujoco
    import mujoco.viewer

    from ..assets import go1_xml

    m = mujoco.MjModel.from_xml_string(go1_xml(ctrl_type))
    mujoco.viewer.launch(m)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    tl = sub.add_parser("timelapse")
    tl.add_argument("video_dir")
    tl.add_argument("--out", default="timelapse.mp4")
    tl.add_argument("--speed", type=int, default=10)
    tr = sub.add_parser("trim")
    tr.add_argument("folder")
    tr.add_argument("seconds", type=float)
    pv = sub.add_parser("preview")
    pv.add_argument("--ctrl_type", default="torque")
    pv.add_argument("--biped", action="store_true")
    pv.add_argument("--fallen", action="store_true")
    pv.add_argument("--device", default="cuda")
    vw = sub.add_parser("view")
    vw.add_argument("--ctrl_type", default="torque")
    a = p.parse_args(argv)
    if a.cmd == "timelapse":
        timelapse(a.video_dir, a.out, a.speed)
    elif a.cmd == "trim":
        trim_videos(a.folder, a.seconds)
    elif a.cmd == "preview":
        preview_initial_pose(a.ctrl_type, a.biped, a.fallen, device=a.device)
    elif a.cmd == "view":
        view_model(a.ctrl_type)


if __name__ == "__main__":
    main()
