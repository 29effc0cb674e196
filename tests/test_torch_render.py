"""The port's offline renderer (viz/render.py) held against the JAX
package's, on the CPU.

  * the bundled mesh-visual scene: its XML and STL meshes equal to the
    reference's, and it compiles in mujoco (tests/test_framework.py's
    check);
  * the wireframe backend (the one a host without mujoco or GL draws
    with): each frame equal, pixel for pixel, to the reference's
    `_wireframe` of the same qpos, over a short trajectory;
  * the mujoco backends on the same qpos, where this host can make a GL
    context (skipped otherwise, with the reason);
  * `write_video`, `render_trajectory` and `render_spool` on a spool the
    port's native writer wrote, as the runner writes it.
"""

import cv2
import numpy as np
import pytest
import torch

from quadruped_tpu.viz import render as JR
from quadruped_tpu_torch.assets import robot_model, robot_xml
from quadruped_tpu_torch.viz import render as TR


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trajectory(robot="go1", T=6):
    """A (T, nq) float32 qpos log: the keyframe walking forward, the trunk
    pitching and rolling a little, the legs swinging."""
    m = robot_model(robot, "torque")
    rng = np.random.default_rng(0)
    q = np.tile(m.key_qpos[0], (T, 1))
    q[:, 0] += np.linspace(0.0, 0.3, T)
    q[:, 2] += 0.02 * np.sin(np.arange(T))
    half = 0.05 * rng.standard_normal((T, 2))
    q[:, 3] = np.cos(half).prod(1)
    q[:, 4], q[:, 5] = np.sin(half[:, 0]), np.sin(half[:, 1])
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    q[:, 7:] += 0.3 * rng.standard_normal((T, 12))
    return q.astype(np.float32)


def _no_gl(*_a, **_k):
    raise RuntimeError("no GL context (test)")


@pytest.mark.parametrize("robot", ["go1", "go2"])
@pytest.mark.parametrize("ctrl", ["torque", "position"])
def test_bundled_visual_model_matches_reference(robot, ctrl):
    import mujoco

    xml, vfs = TR._bundled_visual_model(ctrl, robot=robot)
    jxml, jvfs = JR._bundled_visual_model(ctrl, robot=robot)
    assert xml == jxml
    assert vfs.keys() == jvfs.keys() and all(vfs[k] == jvfs[k] for k in vfs)
    mj = mujoco.MjModel.from_xml_string(xml, vfs)
    phys = mujoco.MjModel.from_xml_string(robot_xml(robot, ctrl))
    assert int((mj.geom_group == 2).sum()) == 13
    assert (mj.nq, mj.nv, mj.nu) == (phys.nq, phys.nv, phys.nu)
    if robot == "go1":
        assert set(vfs) == {"calf.stl", "hip.stl", "thigh.stl",
                            "thigh_mirror.stl", "trunk.stl"}


@pytest.mark.parametrize("robot", ["go1", "go2"])
def test_wireframe_matches_reference(robot, monkeypatch):
    """The wireframe frames of one batched float32 fk equal the
    reference's per-frame `_wireframe` pixel for pixel (its fk runs on
    the float32 log; an fk in float64 moved one go1 frame's line ends by
    a pixel, 117 pixels in all); `frame` of one qpos equals the
    trajectory's first frame."""
    monkeypatch.setattr(TR, "_make_renderer", _no_gl)
    monkeypatch.setattr(JR, "_make_renderer", _no_gl)
    q = _trajectory(robot, 30)
    r = TR.TrajectoryRenderer("torque", 320, 240, robot=robot, device="cpu")
    j = JR.TrajectoryRenderer("torque", 320, 240, robot=robot)
    assert r.backend == j.backend == "wireframe"
    frames = r.frames(q)
    assert len(frames) == len(q)
    for i, (f, qi) in enumerate(zip(frames, q)):
        g = j.frame(qi)
        assert f.shape == g.shape == (240, 320, 3) and f.dtype == np.uint8
        differ = int((f != g).any(-1).sum())
        assert differ == 0, f"frame {i}: {differ} pixels differ"
    np.testing.assert_array_equal(r.frame(q[0]), frames[0])


MUJOCO_FRAMES = """
import sys
import numpy as np
sys.path[:0] = [{root!r}, {tests!r}]
from test_torch_render import _trajectory
from quadruped_tpu.viz import render as JR
from quadruped_tpu_torch.viz import render as TR
q = _trajectory("go1", 3)
r = TR.TrajectoryRenderer("torque", 160, 120, device="cpu")
if r.backend == "wireframe":
    print("NO GL", repr(r._err))
    sys.exit(0)
j = JR.TrajectoryRenderer("torque", 160, 120)
assert r.backend == j.backend == "mujoco-visual", (r.backend, j.backend)
for f, qi in zip(r.frames(q), q):
    np.testing.assert_array_equal(f, j.frame(qi))
r.close()
j.close()
print("EQUAL", len(q))
"""


def test_mujoco_frames_match_reference():
    """Both packages' mujoco backend on the same qpos: the same bundled
    model and camera, so the same pixels.  mujoco picks its GL platform
    when it is first imported, which another test file may already have
    done here, so the comparison runs in a fresh process with MUJOCO_GL
    set, as the renderer sets it; it skips, saying why, where that
    process cannot make a GL context."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    tests = Path(__file__).resolve().parent
    env = dict(os.environ, MUJOCO_GL="egl", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", MUJOCO_FRAMES.format(root=str(tests.parent),
                                                    tests=str(tests))],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    if proc.stdout.startswith("NO GL"):
        pytest.skip(f"mujoco cannot render on this host: {proc.stdout.strip()}")
    assert proc.stdout.strip().endswith("EQUAL 3"), proc.stdout


def _decoded(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return frames


def test_write_video(tmp_path):
    """An mp4v MP4 with every frame, of the frames' size."""
    frames = [np.full((48, 64, 3), v, np.uint8) for v in (0, 100, 200)]
    path = TR.write_video(tmp_path / "sub" / "v.mp4", frames, fps=10)
    got = _decoded(path)
    assert len(got) == 3 and got[0].shape == (48, 64, 3)
    assert abs(int(got[2].mean()) - 200) <= 3


def test_render_spool(tmp_path, monkeypatch):
    """A spool written by the port's native writer as the runner writes
    it (one eval episode's step, reward and qpos records), rendered to an
    MP4 by render_spool (the module's CLI, every second record): as many
    frames as records taken, each the wireframe of its qpos."""
    from quadruped_tpu_torch.native import TrajectoryLog

    monkeypatch.setattr(TR, "_make_renderer", _no_gl)
    q = _trajectory("go1", 8)
    spool = tmp_path / "trajectories" / "eval_8.qtl"
    spool.parent.mkdir()
    with TrajectoryLog(spool, q.shape[-1]) as tl:
        tl.append_batch(8, np.zeros(len(q), np.float32), q)
        tl.flush()
    out = tmp_path / "eval_8.mp4"
    TR.main([str(spool), str(out), "--every", "2", "--width", "160",
             "--height", "120", "--device", "cpu"])
    got = _decoded(out)
    assert len(got) == 4 and got[0].shape == (120, 160, 3)
    want = TR.TrajectoryRenderer("torque", 160, 120, device="cpu").frames(q[::2])
    for g, w in zip(got, want):     # mp4v is lossy: compare loosely
        assert np.abs(g.astype(int) - cv2.cvtColor(w, cv2.COLOR_RGB2BGR)).mean() < 8
