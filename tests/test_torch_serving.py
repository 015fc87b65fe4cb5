"""The port's serving stack on the CPU: the tracker, the dynamic batcher and
HTTP server, streaming and video, held against the JAX package's modules
from the same numpy inputs where those are device-free, and against the
port's own Detector where they run it; and the ``serve``, ``video`` and
``detect --tta --sliced`` commands with ``--device cpu``.  The NMS kernel's
tests are in tests/test_torch_kernels.py, with the other kernels'."""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from chip_smoke import make_frames
from yolofastest_torch.configs import get_config
from yolofastest_torch.inference import (DetectionServer, Detector, DynamicBatcher,
                                         IoUTracker, StreamingDetector, detect_video,
                                         detections_to_lists, make_batch_fn)
from yolofastest_torch.inference import track as ttrack
from yolofastest_torch.inference import video as tvideo
from yolofastest_torch.inference.detector import image_to_net_input
from yolofastest_torch.models import load_variables, zoo_path
from yolofastest_torch.ops import normalize
from yolofastest_tpu.inference import server as jserver
from yolofastest_tpu.inference import track as jtrack
from yolofastest_tpu.inference import video as jvideo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(FIXTURES, "golden_256x320.npz"))


@pytest.fixture(scope="module")
def det():
    return Detector(get_config("256x320"), variables=load_variables(zoo_path("256x320")),
                    device="cpu")


def _rows_close(a, b):
    """Rows of one image through a batch of another size: fp32 sums in
    another order (tests/test_serve.py:48-52)."""
    assert len(a) == len(b)
    if a:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------- track
def _random_tracks(seed, frames=30):
    """Five objects moving at constant speed with jitter, missed at random,
    two of one class crossing, plus a random false positive now and then."""
    rng = np.random.default_rng(seed)
    start = rng.uniform(20, 200, (5, 2))
    size = rng.uniform(15, 40, (5, 2))
    vel = rng.uniform(-4, 4, (5, 2))
    cls = np.array([0, 1, 2, 1, 1], np.int32)
    stream = []
    for f in range(frames):
        xy = start + f * vel + rng.normal(0, 0.7, (5, 2))
        seen = rng.random(5) < 0.8
        boxes = np.concatenate([xy, xy + size], 1)[seen]
        c = cls[seen]
        if rng.random() < 0.3:
            fp = rng.uniform(0, 250, 2)
            boxes = np.concatenate([boxes, [np.concatenate([fp, fp + 20])]])
            c = np.concatenate([c, [rng.integers(0, 3)]])
        scores = rng.random(len(boxes)).astype(np.float32)
        stream.append((boxes.astype(np.float32), c.astype(np.int32), scores))
    return stream


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iou_tracker_matches_jax(seed):
    ours = IoUTracker(iou_thre=0.3, max_age=3, min_hits=2)
    theirs = jtrack.IoUTracker(iou_thre=0.3, max_age=3, min_hits=2)
    for boxes, cls, scores in _random_tracks(seed):
        a, b = ours.update(boxes, cls, scores), theirs.update(boxes, cls, scores)
        assert [(t.tid, t.cls, t.score, t.hits) for t in a] == \
               [(t.tid, t.cls, t.score, t.hits) for t in b]
        for ta, tb in zip(a, b):
            np.testing.assert_array_equal(ta.box, tb.box)
        assert ours.active_tracks == theirs.active_tracks
    assert ours.total_tracks == theirs.total_tracks >= 5


def test_tracker_iou_matrix_and_validation_match_jax():
    rng = np.random.default_rng(4)
    a = np.sort(rng.uniform(0, 50, (6, 2, 2)), axis=1).transpose(0, 2, 1).reshape(6, 4)
    b = np.sort(rng.uniform(0, 50, (4, 2, 2)), axis=1).transpose(0, 2, 1).reshape(4, 4)
    np.testing.assert_array_equal(ttrack._iou_matrix(a, b), jtrack._iou_matrix(a, b))
    for kwargs in ({"iou_thre": 1.0}, {"max_age": 0}, {"min_hits": 0}):
        with pytest.raises(ValueError):
            IoUTracker(**kwargs)
    with pytest.raises(ValueError, match="length mismatch"):
        IoUTracker().update(np.zeros((2, 4)), np.zeros(3, np.int32))


# -------------------------------------------------------------------- batcher
def _echo(batch, n):
    return [[] for _ in batch[:n]]


def test_batcher_snapshot_and_prometheus_equal_jax():
    """Both batchers holding the same counters, latencies and batch fills
    give the same snapshot and the same Prometheus text."""
    ours = DynamicBatcher(_echo, (8, 8), max_batch=4, window_ms=1.0)
    theirs = jserver.DynamicBatcher(_echo, (8, 8), max_batch=4, window_ms=1.0)
    lat = np.random.default_rng(5).uniform(0.1, 30.0, 37).tolist()
    try:
        for b in (ours, theirs):
            b.stats.update(requests=37, batches=14, max_batch_seen=4, errors=1)
            b._lat_ms.extend(lat)
            b._lat_sum_ms = float(sum(lat))
            b._lat_count = len(lat)
            b._fill_counts[:] = [0, 5, 3, 2, 4]
        assert ours.snapshot() == theirs.snapshot()
        assert ours.prometheus_text() == theirs.prometheus_text()
    finally:
        ours.close()
        theirs.close()


def test_batcher_counts_its_own_requests():
    """Five sequential submits through the port's batcher: the invariants of
    tests/test_serve.py:143-174."""
    batcher = DynamicBatcher(_echo, (8, 8), max_batch=4, window_ms=1.0)
    try:
        for _ in range(5):
            assert batcher.submit(np.zeros((8, 8, 1), np.float32)) == []
        snap = batcher.snapshot()
        assert snap["requests"] == 5 and snap["errors"] == 0 and snap["latency_count"] == 5
        assert 0 < snap["latency_ms"]["p50"] <= snap["latency_ms"]["p99"] < 1000
        assert snap["batch_fill"] == {"1": snap["batches"]}
        text = batcher.prometheus_text()
        assert "yf_requests_total 5" in text and "yf_batch_size_sum 5" in text
        assert f'yf_batch_size_bucket{{le="+Inf"}} {snap["batches"]}' in text
        with pytest.raises(ValueError, match="expected net input"):
            batcher.submit(np.zeros((4, 4, 1), np.float32))
    finally:
        batcher.close()
    with pytest.raises(RuntimeError, match="closed"):
        batcher.submit(np.zeros((8, 8, 1), np.float32))


def test_batcher_surfaces_errors_and_keeps_serving():
    calls = {"n": 0}

    def flaky(batch, n):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("device fell over")
        return _echo(batch, n)

    batcher = DynamicBatcher(flaky, (8, 8), max_batch=2, window_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="batch execution failed"):
            batcher.submit(np.zeros((8, 8, 1), np.float32))
        assert batcher.submit(np.zeros((8, 8, 1), np.float32)) == []
        assert batcher.stats["errors"] == 1
    finally:
        batcher.close()


def test_make_batch_fn_takes_run_packed_only():
    class Native:
        def detect(self, img, max_det=64):
            return []

    with pytest.raises(TypeError, match="Native engine"):
        make_batch_fn(Native())
    with pytest.raises(TypeError, match="cannot adapt"):
        make_batch_fn(object())


def test_batcher_replies_equal_detector(det, golden):
    """Eight client threads, two requests each, coalesced into padded
    batches of 4: every reply equals Detector.run on that frame alone."""
    nets = list(_net(golden["pre_imgs"][:8]))
    want = [detections_to_lists(det.run(n[None]))[0] for n in nets]
    batcher = DynamicBatcher(make_batch_fn(det), det.config.io.input_hw, max_batch=4,
                             window_ms=50.0)
    got = {}
    try:
        barrier = threading.Barrier(len(nets))

        def client(i):
            barrier.wait()
            got[i] = [batcher.submit(nets[i]), batcher.submit(nets[(i + 3) % 8])]

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(nets))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for i in range(len(nets)):
            _rows_close(got[i][0], want[i])
            _rows_close(got[i][1], want[(i + 3) % 8])
        assert batcher.stats["requests"] == 16 and batcher.stats["errors"] == 0
        assert batcher.stats["max_batch_seen"] >= 2
    finally:
        batcher.close()


def _net(pre_imgs):
    return (pre_imgs.astype(np.float32)[..., None] - 128.0) / 255.0


# ------------------------------------------------------------------ HTTP
def test_http_server_round_trip(det, golden):
    """POST /detect with a PNG frame: the rows of Detector.run on the same
    decoded image, boxes scaled to the frame; /healthz, /stats, /metrics and
    the error paths (tests/test_serve.py:179-227)."""
    frame = make_frames(golden["pre_imgs"][:1])[0]  # 512x640 BGR
    body = cv2.imencode(".png", frame)[1].tobytes()
    want = detections_to_lists(det.run(image_to_net_input(frame, det.config.io)[None]))[0]
    assert want
    batcher = DynamicBatcher(make_batch_fn(det), det.config.io.input_hw, max_batch=2,
                             window_ms=2.0)
    server = DetectionServer(batcher, det.config, port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        health = json.load(urllib.request.urlopen(f"{base}/healthz", timeout=30))
        assert health["status"] == "ok" and health["input_hw"] == [256, 320]
        req = urllib.request.Request(f"{base}/detect", data=body, method="POST")
        reply = json.load(urllib.request.urlopen(req, timeout=60))
        assert reply["count"] == len(want)
        _rows_close([d["box_net"] + [d["conf"], d["cls_score"], d["cls"]]
                     for d in reply["detections"]], want)
        for d in reply["detections"]:
            assert d["name"] == det.config.io.class_names[d["cls"]]
            np.testing.assert_allclose(d["box"], np.array(d["box_net"]) * 2.0)
        stats = json.load(urllib.request.urlopen(f"{base}/stats", timeout=30))
        assert stats["requests"] >= 1 and stats["errors"] == 0
        metrics = urllib.request.urlopen(f"{base}/metrics", timeout=30)
        assert metrics.headers["Content-Type"].startswith("text/plain")
        assert "yf_batch_size_bucket" in metrics.read().decode()
        bad = urllib.request.Request(f"{base}/detect", data=b"not an image", method="POST")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=30)
        assert ei.value.code == 404
    finally:
        server.close()


# ------------------------------------------------------------------ streaming
@pytest.fixture(scope="module")
def frame_batches(golden):
    """Three uint8 gray batches of 3 golden frames each, one of them ragged
    in content: frames 0-8 of the fixture."""
    pre = golden["pre_imgs"]
    return [pre[3 * k:3 * k + 3].copy() for k in range(3)]


@pytest.mark.parametrize("threaded", [False, True], ids=["sync", "threaded"])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_streaming_equals_run_packed(det, frame_batches, depth, threaded):
    """Every packed result, in order, equals Detector.run_packed on the same
    batch, at depths 1, 2 and 4, sync and threaded."""
    stream = StreamingDetector.over(det, depth=depth, threaded=threaded)
    results = list(stream(iter(frame_batches)))
    assert len(results) == len(frame_batches)
    for got, frames in zip(results, frame_batches):
        want = det.run_packed(normalize(torch.from_numpy(frames))[..., None]).numpy()
        np.testing.assert_array_equal(got["boxes"], want[..., 0:4])
        np.testing.assert_array_equal(got["conf"], want[..., 4])
        np.testing.assert_array_equal(got["count"], (want[..., 7] > 0.5).sum(-1))
    assert sum(int(r["count"].sum()) for r in results) > 0


def test_streaming_detector_options(frame_batches):
    variables = load_variables(zoo_path("256x320"))
    # fold_bn=False streams through the trainable model's eval forward: the
    # same detections as the folded graph, boxes within 1 px
    unfolded = list(StreamingDetector(get_config("256x320"), variables, torch.float32,
                                      fold_bn=False, device="cpu")(iter(frame_batches[:1])))
    folded = list(StreamingDetector(get_config("256x320"), variables, torch.float32,
                                    device="cpu")(iter(frame_batches[:1])))
    np.testing.assert_array_equal(unfolded[0]["count"], folded[0]["count"])
    np.testing.assert_allclose(unfolded[0]["boxes"], folded[0]["boxes"], atol=1.0)
    with pytest.raises(ValueError, match="depth"):
        StreamingDetector(get_config("256x320"), variables, depth=0, device="cpu")
    sd = StreamingDetector(get_config("256x320"), variables, torch.float32, depth=2,
                           device="cpu")
    net_in = [_net(f) for f in frame_batches[:1]]  # float net inputs pass as they are
    a, b = list(sd(iter(frame_batches[:1]))), list(sd(iter(net_in)))
    np.testing.assert_array_equal(a[0]["boxes"], b[0]["boxes"])


def test_streaming_threaded_stops_when_the_consumer_stops(det, frame_batches):
    """Closing the iterator after one result, or an error while fetching,
    while the worker waits on a full queue: the call returns (no hang)."""
    def ten_batches():
        for k in range(10):
            yield frame_batches[k % len(frame_batches)]

    stream = StreamingDetector.over(det, depth=2, threaded=True)
    done = []

    def consume():
        gen = stream(ten_batches())
        next(gen)
        gen.close()
        done.append("closed")

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60)
    assert done == ["closed"]

    class FailingFetch(StreamingDetector):
        @staticmethod
        def _fetch(item):
            raise RuntimeError("fetch failed")

    failing = FailingFetch.over(det, depth=2, threaded=True)
    with pytest.raises(RuntimeError, match="fetch failed"):
        list(failing(ten_batches()))


def test_streaming_threaded_propagates_errors(det):
    stream = StreamingDetector.over(det, depth=2, threaded=True)

    def bad_stream():
        yield np.zeros((1, 256, 320), np.uint8)
        raise RuntimeError("source died")

    with pytest.raises(RuntimeError, match="source died"):
        list(stream(bad_stream()))


# ---------------------------------------------------------------------- video
@pytest.fixture(scope="module")
def clip(golden, tmp_path_factory):
    """A 10-frame MJPG clip of golden frames at 512x640 (2x the net input)."""
    frames = make_frames(golden["pre_imgs"][[0, 0, 1, 1, 1, 2, 2, 3, 3, 3]])
    path = str(tmp_path_factory.mktemp("video") / "ships.avi")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 5.0, (640, 512))
    assert wr.isOpened()
    for f in frames:
        wr.write(f)
    wr.release()
    return path


def test_iter_frame_batches_matches_jax(clip):
    io = get_config("256x320").io
    caps = [cv2.VideoCapture(clip) for _ in range(2)]
    try:
        ours = list(tvideo.iter_frame_batches(caps[0], io, 4))
        theirs = list(jvideo.iter_frame_batches(caps[1], io, 4))
    finally:
        for c in caps:
            c.release()
    assert [n for _, _, n in ours] == [n for _, _, n in theirs] == [4, 4, 2]
    for (a, ao, _), (b, bo, _) in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
        for x, y in zip(ao, bo):
            np.testing.assert_array_equal(x, y)


def test_detect_video_tracks(det, clip, tmp_path):
    """detect_video over the clip with a tracker: every frame written, the
    detections those of Detector.run on the decoded frames, tracks kept."""
    io = det.config.io
    cap = cv2.VideoCapture(clip)
    want = 0
    for nets, _, n in tvideo.iter_frame_batches(cap, io, 4):
        want += sum(len(rows) for rows in detections_to_lists(det.run(nets))[:n])
    cap.release()
    out = str(tmp_path / "out.avi")
    stats = detect_video(det, det.config, clip, out, batch_size=4, depth=2,
                         tracker=IoUTracker(min_hits=1))
    assert stats["frames"] == 10 and stats["fps"] > 0
    # min_hits=1: every detection is matched or opens a track, and is drawn
    assert 1 <= stats["tracks"] <= stats["detections"] == want
    back = cv2.VideoCapture(out)
    assert int(back.get(cv2.CAP_PROP_FRAME_COUNT)) == 10
    back.release()
    raw = detect_video(det, det.config, clip, str(tmp_path / "raw.avi"), batch_size=4, depth=1)
    assert raw["detections"] == want and "tracks" not in raw


def test_detect_video_rejects_bad_sources(det, tmp_path):
    class Native:
        def detect(self, img, max_det=64):
            return []

    with pytest.raises(TypeError, match="Native engine"):
        detect_video(Native(), det.config, "x.avi", str(tmp_path / "o.avi"))
    with pytest.raises(FileNotFoundError):
        detect_video(det, det.config, str(tmp_path / "missing.avi"), str(tmp_path / "o.avi"))


# ------------------------------------------------------------------------ CLI
@pytest.fixture(scope="module")
def image_dir(golden, tmp_path_factory):
    """Two golden frames as .jpg and a third as .png."""
    d = tmp_path_factory.mktemp("images")
    for name, f in zip(("im0.jpg", "im1.jpg", "im2.png"), make_frames(golden["pre_imgs"][:3])):
        cv2.imwrite(str(d / name), f)
    return d


@pytest.mark.parametrize("flags", [["--tta"], ["--sliced", "2x2"], ["--tta", "--sliced", "2x2"]],
                         ids=["tta", "sliced", "tta-sliced"])
def test_cli_detect_tta_sliced_cpu(image_dir, tmp_path, flags):
    """As in the JAX command, --sliced reads the .jpg files only, and the
    whole-frame path .jpg, .png and .bmp."""
    from yolofastest_torch.cli import main

    out = tmp_path / "out"
    rc = main(["detect", "--config", "256x320", "--weights", zoo_path("256x320"),
               "--data", str(image_dir), "--out", str(out), "--device", "cpu", *flags])
    assert rc == 0
    want = ["detect_info.log", "result_im0.jpg", "result_im1.jpg"]
    if "--sliced" not in flags:
        want.append("result_im2.png")
    assert sorted(os.listdir(out)) == want
    log = (out / "detect_info.log").read_text()
    assert log.count("image_name:") == len(want) - 1 and "detect avg_time:" in log
    if "--sliced" in flags:
        assert "2x2 tiles" in log


def test_cli_detect_rejects_bad_arguments(image_dir, tmp_path):
    from yolofastest_torch.cli import main

    base = ["detect", "--weights", zoo_path("256x320"), "--data", str(image_dir),
            "--out", str(tmp_path / "o"), "--device", "cpu"]
    assert main(base + ["--sliced", "2by2"]) == 2
    with pytest.raises(SystemExit, match="anchor group"):
        main(base + ["--arch", "lite"])
    with pytest.raises(SystemExit, match="two-head"):
        main(["detect", "--config", "lite-256x320", "--arch", "lite", "--weights",
              zoo_path("256x320"), "--data", str(image_dir), "--out", str(tmp_path / "o"),
              "--device", "cpu"])


def test_cli_video_cpu(clip, tmp_path, capsys):
    from yolofastest_torch.cli import main

    rc = main(["video", "--config", "lite-256x320", "--arch", "lite",
               "--weights", zoo_path("lite_256x320"), "--video", clip, "--out", str(tmp_path),
               "--batch", "4", "--depth", "2", "--track", "--device", "cpu"])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 10 and "tracks" in stats
    assert os.path.exists(tmp_path / "result_ships.avi")
    assert "video done -> frames:10" in (tmp_path / "video_info.log").read_text()


def test_cli_serve_cpu(golden, tmp_path):
    """`serve --device cpu --port 0`: the server its arguments build answers
    /healthz and one /detect (serve_forever is the only step left out)."""
    from yolofastest_torch.cli import build_parser
    from yolofastest_torch.cli.serve import build_server, cmd_serve

    args = build_parser().parse_args(["serve", "--weights", zoo_path("256x320"), "--device",
                                      "cpu", "--port", "0", "--max-batch", "2"])
    assert args.fn is cmd_serve
    server = build_server(args)
    server.start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert json.load(urllib.request.urlopen(f"{base}/healthz", timeout=60))["status"] == "ok"
        body = cv2.imencode(".png", make_frames(golden["pre_imgs"][:1])[0])[1].tobytes()
        reply = json.load(urllib.request.urlopen(
            urllib.request.Request(f"{base}/detect", data=body, method="POST"), timeout=60))
        assert reply["count"] >= 1
        assert server.batcher.max_batch == 2
    finally:
        server.close()
    args.weights = "w.pth"  # a missing .pth fails in torch.load, as in the JAX loader
    with pytest.raises(FileNotFoundError):
        cmd_serve(args)
    args.weights = str(tmp_path)  # a directory that is no port checkpoint
    assert cmd_serve(args) == 2
