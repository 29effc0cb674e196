"""The port's host tools on the CPU: the monitor server, the video tools
and the minimal example.

The monitor server (monitor/server.py) is held by the five monitor tests
of tests/test_framework.py run against it, and each of its responses is
compared with the JAX package's server's on the same directory (status,
content type, body; the JSON list of videos as parsed).  The video tools
(viz/tools.py) run on short MP4s; preview_initial_pose renders a reset
pose.  The example (examples/minimal_train.py) trains, evaluates and
renders at a tiny size under QTPU_FORCE_CPU.
"""

import json
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import torch

from quadruped_tpu.monitor.server import serve as jax_serve
from quadruped_tpu_torch.monitor.server import parse_range_header, serve
from quadruped_tpu_torch.viz import tools


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mp4(path, n, value=128, size=(64, 48), fps=10):
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    for i in range(n):
        w.write(np.full((size[1], size[0], 3), (value + 10 * i) % 256, np.uint8))
    w.release()


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """The port's and the reference's servers over one directory, each on
    a free loopback port: a fake "video" blob (content, not codec, is what
    the stream tests read), a real 2-frame MP4 and a progress image."""
    base = tmp_path_factory.mktemp("monitor")
    (base / "training_videos").mkdir()
    (base / "training_videos" / "a.mp4").write_bytes(bytes(range(256)) * 4)
    (base / "training_progress.png").write_bytes(b"\x89PNG fake")
    _mp4(base / "training_videos" / "real.mp4", 2)
    ours = serve(port=0, base=str(base), background=True)
    ref = jax_serve(port=0, base=str(base), background=True)
    urls = [f"http://127.0.0.1:{h.server_address[1]}" for h in (ours, ref)]
    yield urls[0], urls[1], base
    for h in (ours, ref):
        h.shutdown()
        h.server_close()


def _get(url, headers=None):
    req = urllib.request.Request(url, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _same(servers, path, headers=None):
    """The response of the port's server, after checking that the
    reference's on the same request has the same status, content type,
    Content-Range and body."""
    ours, ref, _ = servers
    s1, h1, b1 = _get(ours + path, headers)
    s2, h2, b2 = _get(ref + path, headers)
    assert (s1, h1.get("Content-Type"), h1.get("Content-Range")) == (
        s2, h2.get("Content-Type"), h2.get("Content-Range")), path
    if h1.get("Content-Type") == "application/json":
        assert json.loads(b1) == json.loads(b2)
    else:
        assert b1 == b2, path
    return s1, h1, b1


def test_monitor_index(servers):
    status, _, body = _same(servers, "/")
    assert status == 200 and b"a.mp4" in body
    assert _same(servers, "/main")[0] == 200


def test_monitor_api_videos(servers):
    _s, _h, body = _same(servers, "/api/videos")
    vids = {v["name"]: v for v in json.loads(body)}
    assert set(vids) == {"a.mp4", "real.mp4"}
    assert vids["a.mp4"]["size"] == 1024


def test_monitor_thumbnail(servers):
    """/thumb/<name>: a JPEG first frame for a real MP4, 404 for an
    unreadable one; the index links the thumbnails."""
    status, headers, body = _same(servers, "/thumb/real.mp4")
    assert status == 200 and headers["Content-Type"] == "image/jpeg"
    assert body[:2] == b"\xff\xd8"
    assert _same(servers, "/thumb/a.mp4")[0] == 404
    assert b"/thumb/real.mp4" in _same(servers, "/")[2]


def test_monitor_progress_image(servers):
    status, headers, _ = _same(servers, "/training_progress.png")
    assert status == 200 and headers["Content-Type"] == "image/png"
    assert _same(servers, "/showimage")[0] == 200


def test_monitor_range_streaming(servers):
    """206 partial content with the right bytes; open-ended ranges; 200
    without a range; the path traversal guarded; the range parser."""
    data = bytes(range(256)) * 4
    status, headers, body = _same(servers, "/stream/a.mp4", {"Range": "bytes=10-25"})
    assert status == 206 and headers["Content-Range"] == "bytes 10-25/1024"
    assert body == data[10:26]
    status, _h, body = _same(servers, "/stream/a.mp4", {"Range": "bytes=1000-"})
    assert status == 206 and len(body) == 24
    status, _h, body = _same(servers, "/stream/a.mp4")
    assert status == 200 and body == data
    assert _same(servers, "/stream/../../etc/passwd")[0] == 404
    assert parse_range_header("bytes=-", 10) == (0, 9)
    assert parse_range_header("bytes=20-", 10) is None
    assert parse_range_header("items=1-2", 10) is None


def _frames(path):
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def test_timelapse_and_trim(tmp_path):
    """timelapse keeps every Nth frame of each MP4 in a folder, in name
    order; trim_videos drops the first seconds of each (skipping its own
    outputs)."""
    vids = tmp_path / "videos"
    vids.mkdir()
    _mp4(vids / "a.mp4", 10)
    _mp4(vids / "b.mp4", 7)
    out = tools.timelapse(vids, tmp_path / "tl.mp4", speed_factor=3, fps=10)
    assert _frames(out) == 4 + 3
    outs = tools.trim_videos(vids, 0.5)
    assert [p.split("/")[-1] for p in outs] == ["a_trimmed.mp4", "b_trimmed.mp4"]
    assert [_frames(p) for p in outs] == [5, 2]
    assert tools.trim_videos(vids, 0.5) == outs      # trimmed files skipped
    with pytest.raises(FileNotFoundError):
        tools.timelapse(tmp_path / "none")


def test_preview_initial_pose(tmp_path):
    """The reset pose of the port's env, rendered to a PNG through the
    port's renderer (its env and fk on the CPU)."""
    out = tools.preview_initial_pose(out_path=tmp_path / "pose.png", device="cpu")
    img = cv2.imread(out)
    assert img is not None and img.shape == (480, 640, 3) and img.std() > 0


def test_minimal_example_runs(tmp_path, monkeypatch):
    """The example at a tiny size on the CPU (QTPU_FORCE_CPU): one PPO
    iteration of 2 envs x 2 steps, evals of 2 control steps, then the
    rendered video of the final eval."""
    from quadruped_tpu_torch.examples import minimal_train

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("QTPU_FORCE_CPU", "1")
    path = minimal_train.main(["--num_envs", "2", "--n_steps", "2",
                               "--total_timesteps", "4", "--eval_max_time",
                               "0.04", "--solver_iterations", "2"])
    assert _frames(tmp_path / path) == 2
    assert list((tmp_path / "models").glob("*-example/best_model/policy.pt"))
