"""The port's data tools and ``info`` (``yolofastest_torch.data.anchors``,
``txt2xml``, ``lmdb_reader``, ``cli/datatools.py``, ``cli/info.py``,
``models.summary.device_cost_analysis``) on the CPU, held against the JAX
package on the same inputs.

What is held, and how closely:

* the anchor k-means: the same anchors under one seed (bit for bit; the
  port draws from ``default_rng(seed)`` in JAX's order), the shape IoU, the
  fit metric, the groups and the collected shapes equal, and the errors;
  ``anchors``: the same printed table and the same ``--out`` config JSON;
* ``txt2xml``: the same XML files from both txt dialects, the same errors;
* the Caffe-LMDB writer and reader: the same bytes and records, and the same
  errors on JAX ``tests/test_lmdb.py``'s malformed and truncated files;
* ``voc2coco``: the same JSON;
* ``info``: the same text and JSON (86 rows, 118,221,440 MACs and 325,800
  parameters at 256x320); ``--device-cost`` is the port's own count, whose
  operations are within 10% of 2x the MACs (JAX's rule for XLA's count,
  ``tests/test_summary.py:60-68``).

Nothing here compiles a JAX program (XLA's cost analysis is held to the same
rule by that test), so the JAX side runs in the test process.
"""

import contextlib
import io
import json
import os
import struct

import numpy as np
import pytest

from tests._jax_refs import jax_refs  # noqa: F401 (a fixture)
from yolofastest_torch.cli import main
from yolofastest_torch.configs import get_config
from yolofastest_torch.data import anchors as anchors_mod
from yolofastest_torch.data import lmdb_reader
from yolofastest_torch.data.txt2xml import convert_txt_dataset
from yolofastest_torch.models import fold_batchnorm, load_variables, zoo_path
from yolofastest_torch.models.summary import device_cost_analysis, summarize

cv2 = pytest.importorskip("cv2")
# the first port module to run: the JAX references of the later modules start
# compiling here (tests/_jax_refs.py), beside these numpy tests
pytestmark = pytest.mark.usefixtures("jax_refs")
NAMES = ("carrier", "defender", "destroyer")


def run(main_fn, argv):
    """``main_fn(argv)``'s exit code and printed text."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main_fn(argv)
    return rc, out.getvalue()


def jax_main(argv):
    from yolofastest_tpu.cli import main as jmain

    return jmain(argv)


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def raised(fn, *args):
    """(exception type, message) that ``fn(*args)`` raises, or None."""
    try:
        fn(*args)
    except Exception as e:  # noqa: BLE001 (the type is compared)
        return type(e).__name__, str(e)
    return None


# ------------------------------------------------------------------ anchors

@pytest.fixture(scope="module")
def voc_set(tmp_path_factory):
    """8 noise images of 512x640 with 3 boxes each, as a VOC set."""
    from yolofastest_torch.data import write_voc_xml

    root = tmp_path_factory.mktemp("anchors_voc")
    os.makedirs(root / "img")
    os.makedirs(root / "xml")
    rng = np.random.default_rng(0)
    for i in range(8):
        img = rng.integers(0, 40, (512, 640, 3), np.uint8)
        boxes = []
        for _ in range(3):
            bw, bh = int(rng.integers(20, 140)), int(rng.integers(20, 140))
            x1, y1 = int(rng.integers(0, 640 - bw)), int(rng.integers(0, 512 - bh))
            boxes.append((NAMES[i % 3], x1, y1, x1 + bw, y1 + bh))
        cv2.imwrite(str(root / "img" / f"im_{i}.jpg"), img)
        write_voc_xml(str(root / "xml" / f"im_{i}.xml"), f"im_{i}.jpg", (512, 640), boxes)
    return str(root)


@pytest.mark.parametrize("k, seed", [(6, 0), (6, 3), (9, 1), (3, 7)])
def test_kmeans_anchors_match_jax(k, seed):
    """The same anchors under one seed, bit for bit (k-means++ seeding and
    the empty-cluster re-seed consume the rng in JAX's order), and the
    same fit metric and groups."""
    from yolofastest_tpu.data import anchors as janchors

    rng = np.random.default_rng(seed + 100)
    wh = np.concatenate([rng.uniform(5, 200, (60, 2)),
                         rng.normal(30, 2, (40, 2))]).astype(np.float32)
    got = anchors_mod.kmeans_anchors(wh, k, seed=seed)
    want = janchors.kmeans_anchors(wh, k, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert anchors_mod.mean_best_iou(wh, got) == janchors.mean_best_iou(wh, want)
    np.testing.assert_array_equal(anchors_mod.shape_iou(wh, got), janchors.shape_iou(wh, want))
    scales = 3 if k % 3 == 0 else 1
    assert anchors_mod.anchor_groups(got, scales) == janchors.anchor_groups(want, scales)


def test_anchor_helpers_and_errors_match_jax():
    from yolofastest_tpu.configs import get_config as jget_config
    from yolofastest_tpu.data import anchors as janchors

    labels = np.array([[0, 100, 100, 200, 150], [1, 10, 10, 5, 40]], np.float32)
    index = [("a.jpg", labels), ("b.jpg", np.zeros((0, 5), np.float32))]
    np.testing.assert_array_equal(anchors_mod.collect_wh(index, get_config("256x320")),
                                  janchors.collect_wh(index, jget_config("256x320")))
    empty = [("a.jpg", np.zeros((0, 5), np.float32))]
    assert (raised(anchors_mod.collect_wh, empty, get_config("256x320"))
            == raised(janchors.collect_wh, empty, jget_config("256x320")) is not None)
    wh = np.ones((3, 2), np.float32)
    assert (raised(anchors_mod.kmeans_anchors, wh, 6)
            == raised(janchors.kmeans_anchors, wh, 6) is not None)
    six = np.arange(12, dtype=np.float32).reshape(6, 2)
    assert (raised(anchors_mod.anchor_groups, six, 4)
            == raised(janchors.anchor_groups, six, 4) is not None)


@pytest.mark.parametrize("extra", [[], ["--num", "4", "--seed", "5"]])
def test_cli_anchors_matches_jax(voc_set, tmp_path, extra):
    """The same printed table and the same ``--out`` config JSON."""
    argv = ["anchors", "--data", voc_set, *extra]
    rc, ours = run(main, argv + ["--out", str(tmp_path / "t.json")])
    jrc, theirs = run(jax_main, argv + ["--out", str(tmp_path / "j.json")])
    assert rc == jrc == 0
    assert ours.replace("t.json", "j.json") == theirs
    assert "mean best-IoU" in ours and "scale 1 (stride 32)" in ours
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


# ------------------------------------------------------------------ txt2xml

@pytest.fixture(scope="module")
def txt_src(tmp_path_factory):
    """Paired .jpg + .txt files: YOLO rows, the reference's dump, a file
    with a malformed YOLO row (skipped by both), a .txt without an image."""
    src = tmp_path_factory.mktemp("txt_src")
    img = np.zeros((100, 200, 3), np.uint8)
    for stem in ("a", "ref", "std", "mixed"):
        cv2.imwrite(str(src / f"{stem}.jpg"), img)
    (src / "a.txt").write_text("0 0.5 0.5 0.2 0.4\n1 0.25 0.25 0.1 0.1\n")
    (src / "ref.txt").write_text("header line 1\nheader 2\nheader 3\n"
                                 "0 carrier{30,80,70,120}\n1 destroyer{10,20,20,40}\n\n")
    (src / "std.txt").write_text("2 0.75 0.5 0.3 0.3\n")
    (src / "mixed.txt").write_text("1 0.5 0.5 0.2\n2 0.1 0.1 0.1 0.1\n")
    (src / "orphan.txt").write_text("0 0.5 0.5 0.1 0.1\n")
    return src


@pytest.mark.parametrize("dialect, base", [("auto", 0), ("yolo", 1), ("ref-dump", 0)])
def test_cli_txt2xml_matches_jax(txt_src, tmp_path, dialect, base):
    """The same XML (and copied image) files and the same printed line;
    where a file does not parse in the forced dialect, the same error."""
    src = txt_src
    if dialect == "ref-dump":  # every file must be a dump in this dialect
        src = tmp_path / "src"
        src.mkdir()
        for stem in ("ref", "std"):
            (src / f"{stem}.jpg").write_bytes((txt_src / f"{stem}.jpg").read_bytes())
            (src / f"{stem}.txt").write_text((txt_src / "ref.txt").read_text())
    argv = ["txt2xml", "--src", str(src), "--dialect", dialect, "--class-id-base", str(base)]
    rc, ours = run(main, argv + ["--dst", str(tmp_path / "t")])
    jrc, theirs = run(jax_main, argv + ["--dst", str(tmp_path / "j")])
    assert rc == jrc == 0
    assert ours.replace(str(tmp_path / "t"), "D") == theirs.replace(str(tmp_path / "j"), "D")
    got, want = tree_bytes(tmp_path / "t"), tree_bytes(tmp_path / "j")
    assert got == want and len(got) >= 4


def test_txt2xml_errors_match_jax(tmp_path):
    from yolofastest_tpu.data.txt2xml import convert_txt_dataset as jconvert

    img = np.zeros((10, 20, 3), np.uint8)
    cases = {"unreadable": (b"not a jpeg", "0 0.5 0.5 0.2 0.4\n"),
             "malformed": (None, "h\nh\nh\n0 carrier{30,80}\n")}
    for name, (jpg, txt) in cases.items():
        src = tmp_path / name
        src.mkdir()
        if jpg is None:
            cv2.imwrite(str(src / "x.jpg"), img)
        else:
            (src / "x.jpg").write_bytes(jpg)
        (src / "x.txt").write_text(txt)
        got = raised(convert_txt_dataset, str(src), str(tmp_path / f"{name}_t"))
        want = raised(jconvert, str(src), str(tmp_path / f"{name}_j"))
        assert got is not None and got == want, name
    assert (raised(convert_txt_dataset, str(tmp_path), str(tmp_path / "o"), NAMES, 0, "x")
            == raised(jconvert, str(tmp_path), str(tmp_path / "o"), NAMES, 0, "x"))


# --------------------------------------------------------------------- LMDB

def _items(n, shape=(1, 8, 8), seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, shape, dtype=np.uint8), i % 3) for i in range(n)]


LMDB_SETS = {
    "single_leaf": lambda: _items(5),
    "branch_root": lambda: _items(40),
    "overflow": lambda: _items(3) + [
        (np.random.default_rng(1).integers(0, 256, (1, 64, 80), np.uint8), 2),
        (np.random.default_rng(2).integers(0, 256, (3, 40, 50), np.uint8), 0)],
    "empty": lambda: [],
}


@pytest.mark.parametrize("name", sorted(LMDB_SETS))
def test_lmdb_matches_jax(name, tmp_path):
    """The writer's bytes equal JAX's; each reader reads the other's file
    to the same keys, records and length."""
    from yolofastest_tpu.data import lmdb_reader as jlmdb

    items = LMDB_SETS[name]()
    assert (lmdb_reader.write_caffe_lmdb(str(tmp_path / "t"), items)
            == jlmdb.write_caffe_lmdb(str(tmp_path / "j"), items) == len(items))
    blob = (tmp_path / "t" / "data.mdb").read_bytes()
    assert blob == (tmp_path / "j" / "data.mdb").read_bytes()
    ours, theirs = lmdb_reader.CaffeLMDBReader(str(tmp_path / "j")), jlmdb.CaffeLMDBReader(
        str(tmp_path / "t"))
    assert len(ours) == len(theirs) == len(items)
    assert list(ours.items()) == list(theirs.items())
    for (a, la), (b, lb), (c, lc) in zip(ours, theirs, items):
        assert la == lb == lc
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)


def test_datum_codec_matches_jax():
    from yolofastest_tpu.data import lmdb_reader as jlmdb

    arr = np.arange(2 * 3 * 4, dtype=np.uint8).reshape(2, 3, 4)
    assert lmdb_reader.encode_datum(arr, 300) == jlmdb.encode_datum(arr, 300)
    data, label = lmdb_reader.decode_datum(jlmdb.encode_datum(arr, 2))
    assert label == 2
    np.testing.assert_array_equal(data, arr)
    # an unknown field of each wire type is skipped; malformed ones raise alike
    extra = b"\x31" + b"\0" * 8 + b"\x3d" + b"\0" * 4 + lmdb_reader.encode_datum(arr, 1)
    np.testing.assert_array_equal(lmdb_reader.decode_datum(extra)[0], arr)
    for buf in (b"\x08\x01", b"\x08\x02\x10\x02\x18\x02\x22\x01\x00", b"\x08\x80",
                b"\x22\x05ab", b"\x0b", extra[:-3]):
        got, want = raised(lmdb_reader.decode_datum, buf), raised(jlmdb.decode_datum, buf)
        assert got is not None and got == want, buf
    assert raised(lmdb_reader.encode_datum, arr[0], 1) == raised(jlmdb.encode_datum, arr[0], 1)


def test_lmdb_malformed_and_truncated_match_jax(tmp_path):
    """JAX tests/test_lmdb.py's malformed files and every 997th truncation of
    a valid environment: the same records or the same error."""
    from yolofastest_tpu.data import lmdb_reader as jlmdb

    def outcome(reader, path):
        try:
            r = reader(path)
            return len(r), [(k, v) for k, v in r.items()]
        except ValueError as e:
            return "ValueError", str(e)

    assert (outcome(lmdb_reader.CaffeLMDBReader, str(tmp_path / "missing"))
            == outcome(jlmdb.CaffeLMDBReader, str(tmp_path / "missing")))
    bad = tmp_path / "bad"
    bad.mkdir()
    env = str(tmp_path / "env")
    lmdb_reader.write_caffe_lmdb(env, _items(12) + [(np.zeros((1, 64, 80), np.uint8), 1)])
    blob = open(os.path.join(env, "data.mdb"), "rb").read()
    rooted = bytearray(blob)
    for off in (16, 4096 + 16):  # both metas: the main db's root beyond the file
        struct.pack_into("<Q", rooted, off + 24 + 48 + 40, 10_000)
    cases = [b"x" * 9000, bytes(rooted)] + [blob[:cut] for cut in range(0, len(blob), 997)]
    errors = set()
    for case in cases:
        (bad / "data.mdb").write_bytes(case)
        got = outcome(lmdb_reader.CaffeLMDBReader, str(bad))
        assert got == outcome(jlmdb.CaffeLMDBReader, str(bad))
        if got[0] == "ValueError":
            errors.add(got[1].split(":")[1].strip().split(" ")[0])
    assert len(errors) >= 3, errors  # bad meta, root page, file too small, ...


# ----------------------------------------------------------------- voc2coco

def test_cli_voc2coco_matches_jax(voc_set, tmp_path):
    rc, ours = run(main, ["voc2coco", "--src", voc_set, "--dst", str(tmp_path / "t")])
    jrc, theirs = run(jax_main, ["voc2coco", "--src", voc_set, "--dst", str(tmp_path / "j")])
    assert rc == jrc == 0
    assert ours.replace(str(tmp_path / "t"), "D") == theirs.replace(str(tmp_path / "j"), "D")
    assert "converted 8 images" in ours
    assert tree_bytes(tmp_path / "t") == tree_bytes(tmp_path / "j")


# --------------------------------------------------------------------- info

@pytest.mark.parametrize("arch, weights", [("fastest", "256x320"), ("lite", "lite_256x320")])
def test_cli_info_matches_jax(arch, weights, tmp_path):
    """The same table and JSON from the same weights; without --weights the
    port's fresh model gives the same table (shapes need only channel
    counts)."""
    config = "lite-256x320" if arch == "lite" else "256x320"
    argv = ["info", "--config", config, "--arch", arch, "--weights", zoo_path(weights)]
    rc, ours = run(main, argv + ["--json-out", str(tmp_path / "t.json")])
    jrc, theirs = run(jax_main, argv + ["--json-out", str(tmp_path / "j.json")])
    assert rc == jrc == 0
    assert ours.replace("t.json", "j.json") == theirs
    got = json.loads((tmp_path / "t.json").read_text())
    assert got == json.loads((tmp_path / "j.json").read_text())
    fresh_rc, fresh = run(main, ["info", "--config", config, "--arch", arch])
    assert fresh_rc == 0 and fresh == ours.split("wrote")[0]
    if arch == "fastest":
        assert len(got["rows"]) == 86 and got["total_macs"] == 118_221_440
        assert got["total_params"] == 325_800 and "total params: 325,800" in ours


def test_device_cost_counts_the_port(tmp_path):
    """The port's count: operations within 10% of 2x the MACs (the rule
    tests/test_summary.py holds XLA's count to, at the same shapes); bytes at
    least the weights, the input and the heads, the weights' share falling
    with the batch; the ``--device-cost`` line and JSON key."""
    folded = fold_batchnorm(load_variables(zoo_path("256x320")))
    s = summarize(folded, (64, 96))
    cost = device_cost_analysis(folded, (64, 96), batch=1)
    assert cost["batch"] == 1
    assert cost["flops_per_img"] == pytest.approx(2 * s["total_macs"], rel=0.10)
    floor = 4 * (s["total_params"] + 64 * 96 + sum(np.prod(h) for h in s["heads"]))
    assert cost["bytes_per_img"] > floor
    b8 = device_cost_analysis(folded, (64, 96), batch=8)
    assert b8["flops_per_img"] == cost["flops_per_img"]
    assert b8["bytes_per_img"] == pytest.approx(cost["bytes_per_img"]
                                                - 4 * s["total_params"] * 7 / 8)
    rc, out = run(main, ["info", "--device-cost", "--batch", "8",
                         "--json-out", str(tmp_path / "i.json")])
    assert rc == 0 and "port's count of its fp32 forward (batch 8)" in out
    assert json.loads((tmp_path / "i.json").read_text())["device_cost"]["batch"] == 8
