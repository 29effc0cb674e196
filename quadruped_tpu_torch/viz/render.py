"""Offline video rendering: replay logged qpos trajectories to MP4.

The port's copy of quadruped_tpu/viz/render.py.  Training never renders:
the eval logs qpos trajectories (a (T, nq) array copied off the device
once per eval), and this module replays them, writing MP4 via OpenCV.
This replaces the reference's in-loop rgb_array rendering (train.py:53-61
eval env at 1024x768, camera "tracking"; training_callback.py:686-756
VideoRecordingCallback).

Three drawing backends, chosen per host as in the reference:
  * "mujoco-visual": the bundled visual meshes (assets/{robot}_visual.npz)
    injected into the exported physics XML, through mujoco's renderer;
  * "mujoco": the exported physics XML's collision geoms;
  * "wireframe": a side-view skeleton drawn with cv2, on a host without
    mujoco or a GL context.  Its body positions come from the port's
    `physics.kinematics.fk`, run once for the whole trajectory as one
    batch on the renderer's device (the card by default), in float32 as
    the reference's fk runs on the float32 log; the frames are then drawn
    on the host.
`TrajectoryRenderer.backend` says which one ran.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device


def _ensure_gl():
    os.environ.setdefault("MUJOCO_GL", "egl")


def _visual_scene_path(ctrl_type: str) -> str | None:
    """Optional photoreal robot description (visual STL meshes).

    The package ships only the physics constants; if the user points
    QTPU_VISUAL_SCENE at an MJCF with visual meshes (e.g. the upstream
    unitree_go1 scene_{ctrl_type}.xml — same joints, so qpos replays
    directly), videos render with the full mesh look of the reference
    (train.py:53-61 1024x768 'tracking' camera)."""
    cand = os.environ.get("QTPU_VISUAL_SCENE")
    if cand and os.path.exists(cand):
        return cand
    return None


def _stl_bytes(verts: np.ndarray, faces: np.ndarray) -> bytes:
    """Binary STL from (n,3) f32 vertices and (m,3) i32 faces."""
    import struct

    tri = verts[faces]
    m = len(faces)
    rec = np.zeros(
        m, dtype=np.dtype([("n", "<3f4"), ("v", "<9f4"), ("attr", "<u2")])
    )
    rec["v"] = tri.reshape(m, 9)
    return b"\x00" * 80 + struct.pack("<I", m) + rec.tobytes()


def _bundled_visual_model(ctrl_type: str, robot: str = "go1"):
    """(xml, assets) for the self-contained mesh-visual scene.

    assets/{robot}_visual.npz (byte-for-byte copies of the JAX package's)
    carries compact visual meshes and a body->(mesh, quat) placement map.
    Visual geoms are injected into the package's own physics XML in group
    2 (collision geoms live in group 3), so the same model renders
    mesh-quality video with no reference checkout."""
    import json
    import re

    from .. import assets as assets_pkg
    from ..assets import robot_xml

    path = os.path.join(
        os.path.dirname(assets_pkg.__file__), f"{robot}_visual.npz"
    )
    if not os.path.exists(path):
        return None
    npz = np.load(path)
    placements = json.loads(bytes(npz["placements"]).decode())
    meshes = sorted({m for m, _q in placements.values()})
    vfs = {f"{n}.stl": _stl_bytes(npz[f"{n}_v"], npz[f"{n}_f"])
           for n in meshes}

    xml = robot_xml(robot, ctrl_type)
    asset_block = (
        "<asset>"
        + "".join(f'<mesh name="{n}" file="{n}.stl" />' for n in meshes)
        + '<texture type="2d" name="grid" builtin="checker" mark="cross" '
        'rgb1="0.18 0.2 0.23" rgb2="0.24 0.26 0.29" '
        'markrgb="0.8 0.8 0.8" width="300" height="300" />'
        '<material name="grid" texture="grid" texrepeat="4 4" '
        'texuniform="true" reflectance="0.2" />'
        "</asset>"
        '<visual><headlight ambient="0.45 0.45 0.45" '
        'diffuse="0.7 0.7 0.7" specular="0.2 0.2 0.2" /></visual>'
    )
    xml = xml.replace("<worldbody>", asset_block + "<worldbody>", 1)
    xml = xml.replace(
        'rgba="0.5 0.5 0.5 1" name="floor"',
        'material="grid" name="floor"',
    )
    for body, (mesh, quat) in placements.items():
        q = " ".join(str(float(c)) for c in quat)
        rgba = (
            "0.72 0.66 0.2 1" if mesh.startswith("trunk")
            else "0.38 0.39 0.42 1"
        )
        geom = (
            f'<geom type="mesh" mesh="{mesh}" quat="{q}" contype="0" '
            f'conaffinity="0" group="2" rgba="{rgba}" />'
        )
        # insert right after the body's inertial element
        pat = re.compile(
            rf'(<body name="{body}"[^>]*>\s*<inertial[^>]*/>)'
        )
        xml, n = pat.subn(rf"\1{geom}", xml, count=1)
        if n != 1:
            return None
    return xml, vfs


def _box_stl(hx: float, hy: float, hz: float) -> bytes:
    """Binary STL of an axis-aligned box with half-sizes (hx, hy, hz)."""
    import struct

    v = [
        (sx * hx, sy * hy, sz * hz)
        for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
    ]
    faces = [
        (0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5),   # x- x+
        (0, 4, 5), (0, 5, 1), (2, 3, 7), (2, 7, 6),   # y- y+
        (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3),   # z- z+
    ]
    out = b"\x00" * 80 + struct.pack("<I", len(faces))
    for a, b, c in faces:
        out += struct.pack("<3f", 0, 0, 0)
        for p in (v[a], v[b], v[c]):
            out += struct.pack("<3f", *p)
        out += b"\x00\x00"
    return out


def _make_renderer(ctrl_type: str, width: int, height: int,
                   robot: str = "go1"):
    """mujoco renderer: photoreal visual scene when available, otherwise
    the exported physics XML (collision geoms, group 3)."""
    _ensure_gl()
    import mujoco

    visual = _visual_scene_path(ctrl_type)
    if visual is None:
        try:
            bundled = _bundled_visual_model(ctrl_type, robot=robot)
            if bundled is not None:
                xml, vfs = bundled
                mj = mujoco.MjModel.from_xml_string(xml, vfs)
                renderer = mujoco.Renderer(mj, height=height, width=width)
                return mj, renderer, True
        except Exception:
            pass
    if visual is not None:
        try:
            # the upstream XML references includes/STLs without a meshdir;
            # hand the loader a virtual filesystem keyed by basename
            import glob as _glob
            import re

            base = os.path.dirname(visual)
            with open(visual) as fh:
                xml = fh.read()
            assets = {}
            for f in _glob.glob(os.path.join(base, "*.xml")):
                assets[os.path.basename(f)] = Path(f).read_bytes()
            for f in _glob.glob(os.path.join(base, "assets", "*")):
                # mujoco keys virtual files by basename; the XML references
                # them as assets/<name>
                assets["assets/" + os.path.basename(f)] = Path(f).read_bytes()
            # the upstream checkout is missing trunk.stl; give any missing
            # mesh a synthesized box so the legs still render with their
            # real meshes
            robot_xmls = [
                assets[k].decode() for k in assets if k.endswith(".xml")
            ] + [xml]
            for rx in robot_xmls:
                for fname in re.findall(r'file="([^"]+\.stl)"', rx):
                    key = "assets/" + os.path.basename(fname)
                    if key not in assets:
                        assets[key] = _box_stl(0.1335, 0.097, 0.057)
            mj = mujoco.MjModel.from_xml_string(xml, assets)
            renderer = mujoco.Renderer(mj, height=height, width=width)
            return mj, renderer, True
        except Exception:
            pass

    from ..assets import robot_xml

    mj = mujoco.MjModel.from_xml_string(robot_xml(robot, ctrl_type))
    renderer = mujoco.Renderer(mj, height=height, width=width)
    return mj, renderer, False


class TrajectoryRenderer:
    """Replays (T, nq) qpos logs through mujoco, or draws a wireframe on a
    host without mujoco or GL.  `device` is where the wireframe's batched
    fk runs (default the card; tests pass "cpu")."""

    def __init__(self, ctrl_type: str = "torque", width: int = 640,
                 height: int = 480, robot: str = "go1", device="cuda"):
        self.width, self.height = width, height
        self.ctrl_type = ctrl_type
        self.robot = robot
        self.device = resolve_device(device)
        from ..assets import robot_model

        self.m = robot_model(robot, ctrl_type)   # the wireframe's kinematics
        self.backend = "none"
        try:
            self.mj, self.renderer, visual = _make_renderer(
                ctrl_type, width, height, robot=robot
            )
            import mujoco

            self.d = mujoco.MjData(self.mj)
            self._mujoco = mujoco
            self.scene_option = mujoco.MjvOption()
            if visual:
                # mesh-visual model: default geom groups show the meshes
                self.backend = "mujoco-visual"
            else:
                # physics-only model: show collision geoms (group 3)
                self.scene_option.geomgroup[:] = 0
                self.scene_option.geomgroup[3] = 1
                self.scene_option.geomgroup[0] = 1
                self.backend = "mujoco"
            # tracking camera equivalent (reference camera "tracking",
            # go1_torque.xml:84)
            self.camera = mujoco.MjvCamera()
            self.camera.distance = 2.0
            self.camera.elevation = -20.0
            self.camera.azimuth = 90.0
        except Exception as e:  # a host without mujoco or a GL context
            self._err = e
            self.backend = "wireframe"

    def frames(self, qpos_log) -> list[np.ndarray]:
        """RGB frames (H, W, 3) uint8 of a (T, nq) qpos log."""
        qpos_log = np.asarray(qpos_log)
        if self.backend.startswith("mujoco"):
            return [self._mujoco_frame(q) for q in qpos_log]
        return self._wireframes(qpos_log)

    def frame(self, qpos) -> np.ndarray:
        """The RGB frame of one qpos (nq,)."""
        return self.frames(np.asarray(qpos)[None])[0]

    def _mujoco_frame(self, qpos: np.ndarray) -> np.ndarray:
        self.d.qpos[:] = qpos
        self._mujoco.mj_forward(self.mj, self.d)
        self.camera.lookat[:] = self.d.qpos[:3]
        self.renderer.update_scene(
            self.d, camera=self.camera, scene_option=self.scene_option
        )
        return self.renderer.render()

    def _wireframes(self, qpos_log: np.ndarray) -> list[np.ndarray]:
        """2D side-view skeletons: body positions from one batched fk on
        the renderer's device, then cv2 on the host."""
        import cv2

        from ..physics.kinematics import fk

        m = self.m
        if len(qpos_log) == 0:
            return []
        qpos = torch.as_tensor(qpos_log, dtype=torch.float32, device=self.device)
        kin = fk(m, qpos, torch.zeros((qpos.shape[0], m.nv), device=self.device))
        xpos_all = kin.xpos.cpu().numpy()
        ground = int(self.height * 0.8)
        out = []
        for q, xpos in zip(qpos_log, xpos_all):
            img = np.full((self.height, self.width, 3), 255, np.uint8)

            def to_px(p, x0=q[0]):
                x = int(self.width / 2 + (p[0] - x0) * 300)
                y = int(self.height * 0.8 - p[2] * 300)
                return x, y

            cv2.line(img, (0, ground), (self.width, ground), (0, 0, 0), 1)
            for b in range(1, m.nbody):
                p = int(m.body_parentid[b])
                if p == 0:
                    continue
                cv2.line(img, to_px(xpos[p]), to_px(xpos[b]), (40, 40, 200), 2)
            cv2.circle(img, to_px(xpos[1]), 6, (200, 60, 40), -1)
            out.append(img)
        return out

    def close(self):
        if self.backend.startswith("mujoco"):
            self.renderer.close()


def write_video(path, frames, fps: int = 30) -> str:
    """MP4 via OpenCV."""
    import cv2

    path = str(path)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    for f in frames:
        writer.write(cv2.cvtColor(np.asarray(f), cv2.COLOR_RGB2BGR))
    writer.release()
    return path


def render_trajectory(
    qpos_log, path, ctrl_type: str = "torque", fps: int = 30,
    robot: str = "go1",
    width: int = 640, height: int = 480, every: int = 1, device="cuda",
) -> str:
    """qpos log (T, nq) -> MP4 at `path` (the runner names the file)."""
    r = TrajectoryRenderer(ctrl_type, width, height, robot=robot, device=device)
    try:
        frames = r.frames(np.asarray(qpos_log)[::every])
    finally:
        r.close()
    return write_video(path, frames, fps)


def render_spool(
    spool_path, out_path, ctrl_type: str = "torque", fps: int = 30,
    width: int = 640, height: int = 480, every: int = 1, device="cuda",
) -> str:
    """Render a native trajectory spool (see native/trajlog.cpp) to MP4.

    The runner spools every eval episode asynchronously; this function (or
    the module CLI below) turns spools into videos in a separate process,
    so the training loop never waits on rendering."""
    from ..native import read_log

    _, _, qpos = read_log(spool_path)
    return render_trajectory(
        qpos, out_path, ctrl_type, fps=fps, width=width, height=height,
        every=every, device=device,
    )


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Render a .qtl trajectory spool to MP4"
    )
    p.add_argument("spool")
    p.add_argument("out")
    p.add_argument("--ctrl_type", default="torque")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--every", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="where the wireframe's fk runs (cuda or cpu)")
    a = p.parse_args(argv)
    out = render_spool(
        a.spool, a.out, a.ctrl_type, fps=a.fps, width=a.width,
        height=a.height, every=a.every, device=a.device,
    )
    print(out)


if __name__ == "__main__":
    main()
