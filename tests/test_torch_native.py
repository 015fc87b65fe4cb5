"""The port's native engine (``yolofastest_torch.native``) and the native
backends of its commands, on the CPU, held against the JAX package.

Both packages load the same unchanged C++ library of ``cpp/``, so what is
held is what the port stages and how it drives the engine:

* the ``.yfb`` files: the port's byte for byte equal to JAX's, fp32 and the
  three shipped int8 artifacts (``mixed_native_tree`` with their scales);
* the port's engine on the port's file against JAX's engine on JAX's file:
  heads and rows equal bit for bit; the heads within ``rtol=1e-4,
  atol=2e-3`` of the port's folded fp32 forward (JAX's tolerance,
  ``tests/test_native.py:51-63``);
* golden recall by the golden suite's rule (class and IoU > 0.5): 34/34
  and 33/33 in fp32; ``native-int8`` on the shipped artifacts 34/34,
  33/33 and pruned 34/34 with 57, 57 and 56 int8 layers
  (``docs/golden_suite_summary.json``); ``YF_INT8=0`` runs 0 int8 layers;
* ``make_batch_fn``, ``make_backend_eval_fn`` and ``detect_video`` over the
  engine against JAX's on the same engine;
* ``detect``, ``serve`` (its batch function), ``video`` and ``eval`` with
  ``--backend native|native-int8`` against the JAX commands: equal
  ``model.yfb``, rows, result images and mAP; the misuse exits with JAX's
  lines.

The library is looked up when a test runs (``cpp/build/libyf.so``, which
the JAX package's tests build earlier in a full run, or the port's own
build under ``build/native``); where neither exists the tests that need it
skip with that reason, and these tests never build it.  Nothing here
compiles a JAX program, so the JAX side runs in the test process.
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest

from chip_smoke import make_frames, recall_iou
from yolofastest_torch.cli import main
from yolofastest_torch.configs import get_config
from yolofastest_torch.export import save_native_weights
from yolofastest_torch.models import (fold_batchnorm, folded_apply, load_variables,
                                      torch_params_from_folded, zoo_path)
from yolofastest_torch.native import NativeEngine, available_library
from yolofastest_torch.quant import int8_zoo_path, load_int8_zoo, mixed_native_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
PRUNED_ART = os.path.join(ROOT, "weights", "yolofastest_int8_pruned040_256x320.npz")
ARTIFACTS = {"256x320": ("256x320", int8_zoo_path("256x320"), 57),
             "512x640": ("512x640", int8_zoo_path("512x640"), 57),
             "pruned040": ("256x320", PRUNED_ART, 56)}
cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module")
def lib():
    """The library path, decided now: a module-level skip would see no
    ``cpp/build/libyf.so`` on a clean checkout before the JAX tests build it."""
    path = available_library()
    if path is None:
        pytest.skip("native library not built (neither cpp/build/libyf.so from cpp/build.sh "
                    "nor the port's build/native/libyf-<hash>.so); these tests do not build it")
    return path


def golden(res):
    fx = np.load(os.path.join(FIXTURES, f"golden_{res}.npz"))
    return (fx["pre_imgs"].astype(np.float32)[..., None] - 128.0) / 255.0, fx["boxes"]


def jax_yfb(tree, path, cfg, act_scales=None):
    from yolofastest_tpu.configs import get_config as jget_config
    from yolofastest_tpu.export import save_native_weights as jsave

    jsave(tree, path, act_scales=act_scales, io_config=jget_config(cfg).io)


def engines(tmp_path, tree, cfg_name, act_scales=None):
    """(port engine on the port's file, JAX engine on JAX's file), after
    checking the two files are byte for byte equal."""
    from yolofastest_tpu.configs import get_config as jget_config
    from yolofastest_tpu.native import NativeEngine as JNativeEngine

    cfg = get_config(cfg_name)
    ours, theirs = str(tmp_path / "t.yfb"), str(tmp_path / "j.yfb")
    save_native_weights(tree, ours, act_scales=act_scales, io_config=cfg.io)
    jax_yfb(tree, theirs, cfg_name, act_scales)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    return NativeEngine(ours, cfg), JNativeEngine(theirs, jget_config(cfg_name))


def all_rows(engine, x):
    return [engine.detect(img) for img in x]


@pytest.fixture(scope="module")
def fp_engines(lib, tmp_path_factory):
    """Per resolution: the folded zoo weights and both engines over them."""
    out = {}
    for res in ("256x320", "512x640"):
        folded = fold_batchnorm(load_variables(zoo_path(res)))
        out[res] = (folded, *engines(tmp_path_factory.mktemp(f"fp{res}"), folded, res))
    return out


@pytest.mark.parametrize("res", ["256x320", "512x640"])
def test_engine_matches_jax_and_folded_forward(fp_engines, res):
    """Equal .yfb files; heads and rows equal to JAX's engine's bit for bit;
    heads within JAX's tolerance of the port's folded forward; the golden
    boxes by the suite's rule."""
    folded, ours, theirs = fp_engines[res]
    x, boxes = golden(res)
    assert not ours.is_lite and ours.int8_layers == 0
    import torch

    ref = folded_apply(torch_params_from_folded(folded, torch.device("cpu")),
                       torch.from_numpy(x[:2]))
    for i in range(2):
        got, want = ours.forward(x[i]), theirs.forward(x[i])
        for g, w, r in zip(got, want, ref):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_allclose(g, r[i].numpy(), rtol=1e-4, atol=2e-3)
    rows = all_rows(ours, x)
    assert rows[:4] == all_rows(theirs, x[:4])  # equal files, one library: equal rows
    assert recall_iou(rows, boxes) == len(boxes) == {"256x320": 34, "512x640": 33}[res]


@pytest.mark.parametrize("name", sorted(ARTIFACTS))
def test_native_int8_artifacts(lib, name, tmp_path):
    """The shipped int8 artifacts staged as ``native-int8 --int8-zoo``
    stages them: equal files, int8 layer counts, equal rows, full recall."""
    from yolofastest_tpu.quant import load_int8_zoo as jload_int8_zoo
    from yolofastest_tpu.quant import mixed_native_tree as jmixed

    res, path, n_int8 = ARTIFACTS[name]
    folded, scales, keep = load_int8_zoo(path)
    tree, nscales = mixed_native_tree(folded, scales, keep)
    ours, theirs = engines(tmp_path, tree, res, nscales)
    jtree, jscales = jmixed(*jload_int8_zoo(path))
    jax_yfb(jtree, str(tmp_path / "j2.yfb"), res, jscales)  # JAX's own tree: the same bytes
    assert (tmp_path / "j2.yfb").read_bytes() == (tmp_path / "t.yfb").read_bytes()
    assert ours.int8_layers == theirs.int8_layers == n_int8
    x, boxes = golden(res)
    rows = all_rows(ours, x)
    assert rows[:4] == all_rows(theirs, x[:4])
    assert recall_iou(rows, boxes) == len(boxes)


def test_int8_off_by_environment(lib, tmp_path, monkeypatch):
    """``YF_INT8=0`` (read by the library when an engine is made) keeps every
    layer in fp32; a lite file with a two-head config is refused as JAX's."""
    folded, scales, keep = load_int8_zoo(int8_zoo_path("256x320"))
    tree, nscales = mixed_native_tree(folded, scales, keep)
    yfb = str(tmp_path / "m.yfb")
    save_native_weights(tree, yfb, act_scales=nscales)
    monkeypatch.setenv("YF_INT8", "0")
    assert NativeEngine(yfb, get_config("256x320")).int8_layers == 0
    monkeypatch.delenv("YF_INT8")
    assert NativeEngine(yfb, get_config("256x320")).int8_layers == 57
    save_native_weights(fold_batchnorm(load_variables(zoo_path("lite_256x320"))), yfb)
    eng = NativeEngine(yfb, get_config("lite-256x320"))
    assert eng.is_lite and len(eng.forward(golden("256x320")[0][0])) == 1
    with pytest.raises(ValueError, match="weights are lite but config has 2"):
        NativeEngine(yfb, get_config("256x320"))
    with pytest.raises(FileNotFoundError, match="native library not built"):
        NativeEngine(yfb, get_config("lite-256x320"), library_path=str(tmp_path / "no.so"))


def test_adapters_match_jax(fp_engines, tmp_path):
    """``make_batch_fn``, ``make_backend_eval_fn`` and ``detect_video`` over
    the port's engine equal the JAX functions over the same engine."""
    from yolofastest_torch.eval import make_backend_eval_fn
    from yolofastest_torch.inference import IoUTracker, detect_video, make_batch_fn
    from yolofastest_tpu.configs import get_config as jget_config
    from yolofastest_tpu.eval import make_backend_eval_fn as jmake_backend_eval_fn
    from yolofastest_tpu.inference import IoUTracker as JIoUTracker
    from yolofastest_tpu.inference import detect_video as jdetect_video
    from yolofastest_tpu.inference import make_batch_fn as jmake_batch_fn

    _, eng, _ = fp_engines["256x320"]
    x, _ = golden("256x320")
    batch = x[:4]
    assert make_batch_fn(eng, max_det=3)(batch, 3) == jmake_batch_fn(eng, max_det=3)(batch, 3)
    got = make_backend_eval_fn(eng, max_det=8)(None, batch)
    want = jmake_backend_eval_fn(eng, max_det=8)(None, batch)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    clip = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"MJPG"), 25.0, (640, 512))
    for frame in make_frames(np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
                             ["pre_imgs"][:5]):
        writer.write(frame)
    writer.release()
    stats = detect_video(eng, eng.config, clip, str(tmp_path / "t.avi"), batch_size=2,
                         tracker=IoUTracker())
    jstats = jdetect_video(eng, jget_config("256x320"), clip, str(tmp_path / "j.avi"),
                           batch_size=2, tracker=JIoUTracker())
    for key in ("frames", "detections", "src_fps", "tracks"):
        assert stats[key] == jstats[key], key
    assert stats["frames"] == 5 and stats["tracks"] > 0
    assert (tmp_path / "t.avi").read_bytes() == (tmp_path / "j.avi").read_bytes()


# --------------------------------------------------------------- commands

@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """Four golden frames as 512x640 .jpg files, a VOC set of them with the
    golden_map targets, and a 4-frame video."""
    from yolofastest_torch.data import write_voc_xml

    root = tmp_path_factory.mktemp("native_cli")
    imgs, xml = root / "voc" / "img", root / "voc" / "xml"
    os.makedirs(imgs)
    os.makedirs(xml)
    frames = make_frames(np.load(os.path.join(FIXTURES, "golden_256x320.npz"))["pre_imgs"][:4])
    targets = np.load(os.path.join(FIXTURES, "golden_map.npz"))["targets"]
    names = get_config("256x320").io.class_names
    writer = cv2.VideoWriter(str(root / "clip.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 25.0,
                             (640, 512))
    for i, frame in enumerate(frames):
        cv2.imwrite(str(imgs / f"g{i}.jpg"), frame)
        writer.write(frame)
        rows = targets[i][targets[i][:, 5] > 1]
        write_voc_xml(str(xml / f"g{i}.xml"), f"g{i}.jpg", (512, 640, 3),
                      [(names[int(c)], (xc - w / 2) * 640, (yc - h / 2) * 512,
                        (xc + w / 2) * 640, (yc + h / 2) * 512) for xc, yc, w, h, c, _ in rows])
    writer.release()
    return root


def run(main_fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main_fn(argv)
    return rc, out.getvalue(), err.getvalue()


def jax_main(argv):
    from yolofastest_tpu.cli import main as jmain

    return jmain(argv)


def untimed(result):
    """A command's (code, stdout, stderr) without the log lines' timestamps."""
    return tuple(re.sub(r"^[0-9-]+ [0-9:,]+——", "", r, flags=re.M) if isinstance(r, str)
                 else r for r in result)


def log_lines(blob):
    """A log's messages with the times taken out."""
    return [re.sub(r"[0-9.]+ms", "ms", ln.split("——")[1]) for ln in blob.decode().splitlines()]


def files(root, prefix=""):
    return {f: (root / f).read_bytes() for f in sorted(os.listdir(root))
            if f.startswith(prefix)}


@pytest.mark.parametrize("backend, extra", [
    ("native", []), ("native-int8", ["--int8-zoo"]), ("native-int8", ["calibrate"])])
def test_cli_detect_matches_jax(lib, cli_data, tmp_path, backend, extra):
    """``detect --backend native|native-int8``: the same ``model.yfb``, result
    images and log lines (times aside).  Calibrating, the port runs on a
    cache miss and writes the cache, which the JAX command then reads."""
    cache = tmp_path / "c.json"
    if extra == ["calibrate"]:
        extra = ["--calibration-cache", str(cache)]
    base = ["detect", "--weights", zoo_path("256x320"), "--data", str(cli_data / "voc" / "img"),
            "--backend", backend, *extra]
    rc, _, _ = run(main, base + ["--out", str(tmp_path / "t"), "--device", "cpu"])
    assert cache.exists() == ("--calibration-cache" in extra)
    jrc, _, _ = run(jax_main, base + ["--out", str(tmp_path / "j")])
    assert rc == jrc == 0
    got, want = files(tmp_path / "t"), files(tmp_path / "j")
    assert got.keys() == want.keys() and len(got) == 6
    for f in got:
        if f == "detect_info.log":
            assert log_lines(got[f]) == log_lines(want[f])
        else:
            assert got[f] == want[f], f


@pytest.mark.parametrize("backend", ["native", "native-int8"])
def test_cli_eval_serve_video_match_jax(lib, cli_data, tmp_path, backend):
    """``eval``, ``serve`` and ``video`` with a native backend against the
    JAX commands: the same mAP line and metrics, the same batch-function
    rows, the same tracked video.  The int8 one reads the shipped 256x320
    artifact's scales from a cache (JAX's ``serve`` and ``video`` have no
    ``--int8-zoo``)."""
    from yolofastest_torch.cli import build_parser
    from yolofastest_torch.cli.serve import build_server
    from yolofastest_tpu.cli._common import _build_engine
    from yolofastest_tpu.cli._common import _get_config as jget_config
    from yolofastest_tpu.cli.parser import build_parser as jbuild_parser
    from yolofastest_tpu.inference import make_batch_fn as jmake_batch_fn

    cache = []
    if backend == "native-int8":
        (tmp_path / "c.json").write_text(json.dumps(load_int8_zoo("256x320")[1]))
        cache = ["--calibration-cache", str(tmp_path / "c.json")]
    model = ["--weights", zoo_path("256x320"), "--backend", backend, *cache]
    ev = ["eval", "--val-dir", str(cli_data / "voc"), *model]
    rc, out, _ = run(main, ev + ["--log-dir", str(tmp_path / "tl"), "--json-out",
                                 str(tmp_path / "t.json"), "--device", "cpu"])
    jrc, jout, _ = run(jax_main, ev + ["--log-dir", str(tmp_path / "jl"), "--json-out",
                                       str(tmp_path / "j.json")])
    assert rc == jrc == 0
    assert out.splitlines()[0] == jout.splitlines()[0] and out.startswith("mAP: 0.")
    got, want = (json.loads((tmp_path / f).read_text()) for f in ("t.json", "j.json"))
    assert got == want and got["backend"] == backend

    serve = ["serve", *model, "--port", "0", "--max-batch", "2"]
    server = build_server(build_parser().parse_args(serve + ["--device", "cpu"]))
    server.start()
    try:
        assert server.backend == backend
        x, _ = golden("256x320")
        rows = [server.batcher.submit(x[i]) for i in range(3)]
    finally:
        server.close()
    jargs = jbuild_parser().parse_args(serve)
    jcfg = jget_config(jargs)
    jfn = jmake_batch_fn(_build_engine(jargs, jcfg, backend, None), max_det=jcfg.io.max_det)
    assert rows == jfn(x[:3], 3)

    video = ["video", "--video", str(cli_data / "clip.avi"), "--batch", "3", "--track", *model]
    rc, out, _ = run(main, video + ["--out", str(tmp_path / "tv"), "--device", "cpu"])
    jrc, jout, _ = run(jax_main, video + ["--out", str(tmp_path / "jv")])
    assert rc == jrc == 0
    stats, jstats = json.loads(out), json.loads(jout)
    for key in ("frames", "detections", "tracks", "src_fps"):
        assert stats[key] == jstats[key], key
    assert files(tmp_path / "tv", "result_") == files(tmp_path / "jv", "result_")


@pytest.mark.parametrize("command, flags", [
    ("detect", ["--tta"]), ("detect", ["--sliced", "2x2"]), ("detect", ["--int8-zoo"]),
    ("video", ["--tta"]), ("eval", ["--int8-zoo"]), ("eval", ["--tta"]),
    ("detect", ["--backend", "native-int8", "--calibration-cache", "{tmp}/c.json"]),
    ("video", ["--backend", "native-int8", "--calibration-cache", "{tmp}/c.json"])])
def test_cli_native_misuse_exits_as_jax(tmp_path, command, flags):
    """Misused flags on a native backend exit 2 with the JAX command's line,
    before any engine is made (no library needed); a native-int8 run with
    nothing to calibrate on and no cache, likewise."""
    flags = [f.replace("{tmp}", str(tmp_path)) for f in flags]
    os.makedirs(tmp_path / "xml")  # an empty VOC set for eval
    base = {"detect": ["--data", str(tmp_path), "--out", str(tmp_path / "o")],
            "video": ["--video", "v.avi", "--out", str(tmp_path / "o")],
            "eval": ["--val-dir", str(tmp_path), "--log-dir", str(tmp_path / "l")]}[command]
    argv = [command, "--weights", zoo_path("256x320"), "--backend", "native", *base, *flags]
    got = untimed(run(main, argv + ["--device", "cpu"]))
    want = untimed(run(jax_main, argv))
    assert got == want and got[0] == 2 and (got[1] + got[2]).strip()
    assert not os.path.exists(tmp_path / "c.json")


def test_cli_native_keep_fp_refused(tmp_path):
    """``--keep-fp`` on a native backend exits 2 with the line the JAX
    package prints for it on every other backend (JAX's native branches do
    not read the flag and run without it)."""
    from yolofastest_tpu.cli._common import _parse_keep_fp

    for backend in ("native", "native-int8"):
        argv = ["detect", "--weights", zoo_path("256x320"), "--data", str(tmp_path), "--out",
                str(tmp_path / "o"), "--backend", backend, "--keep-fp", "conv2_2",
                "--device", "cpu"]
        rc, out, err = run(main, argv)
        args = type("Args", (), {"keep_fp": "conv2_2", "int8_zoo": None})()
        _, _, want = run(lambda _: _parse_keep_fp(args, backend), None)
        assert rc == 2 and err == want and "--keep-fp (mixed precision)" in err
