"""The port's export and import (``yolofastest_torch.export``,
``models.torch_io``, ``quant.quantize_weights``) and its ``export``,
``convert`` and ``detect`` commands on the CPU, held against the JAX package.

* Each file the port writes for the folded 256x320 and lite zoo trees is
  byte-equal to the JAX writer's (ONNX: all but the producer name, field 2
  of the ModelProto).
* Each import (ONNX in both forms, ncnn, a reference-layout ``.pth``) gives
  the tree the JAX import of the same file gives, bit for bit; bad input
  fails with the JAX reader's exception class.
* TorchScript heads equal JAX's ``build_torch_module`` to 1e-6.
* ``export`` writes JAX's file list minus its four JAX-program files;
  ``convert`` writes the ``.npz`` JAX's command writes.
* The numpy-only consumers ``tools/{onnx,ncnn,caffe}_check.py`` run the
  port's files to the port's heads.
* ``detect`` against the JAX command (workers of ``tests/_jax_refs.py``): a
  port checkpoint directory, ``--config-json``, ``--fold-bn`` either way,
  ``--backend jax``, and ``--sliced`` reading ``.jpg`` only.

The JAX writers and readers are numpy and run here in the test process.
"""

import atexit
import os
import re
import shutil
import sys
import tempfile

import numpy as np
import pytest
import torch

import yolofastest_torch.export as P
import yolofastest_tpu.export as J
from chip_smoke import make_frames
from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from yolofastest_torch.configs import get_config
from yolofastest_torch.export.onnx import (_attr_int, _attr_ints, _ld, _node, _OnnxExecutor,
                                           _r_fields, _s, _serialize, _tensor)
from yolofastest_torch.models import fold_batchnorm, load_variables, zoo_path
from yolofastest_torch.models.torch_io import variables_to_torch_state_dict
from yolofastest_torch.models.zoo import _flatten
from yolofastest_torch.quant import quantize_weights
from yolofastest_tpu.configs import get_config as jget_config
from yolofastest_tpu.quant import quantize_weights as jquantize_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
cv2 = pytest.importorskip("cv2")
pytestmark = pytest.mark.usefixtures("jax_refs")

ARCHS = {"fastest": ("256x320", "256x320", "yolofastest"),
         "lite": ("lite_256x320", "lite-256x320", "yolofastest-lite")}  # zoo, config, graph
# JAX export's files; the last four are JAX programs, which the port does not write
JAX_EXPORT_FILES = ["model.yfb", "model_int8.yfb", "model.onnx", "detect.onnx", "model.param",
                    "model.bin", "model.prototxt", "model.caffemodel", "model.pt"]
JAX_PROGRAM_FILES = ["forward.stablehlo", "forward.mlir", "detect.stablehlo", "detect.mlir"]


def _golden_x(n):
    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    return (fx["pre_imgs"][:n].astype(np.float32)[:, None] - 128.0) / 255.0  # NCHW


def _assert_trees_equal(got, want):
    a, b = _flatten(got), _flatten(want)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _model_fields(path):
    """The top-level fields of an ONNX ModelProto, producer name aside."""
    fields = list(_r_fields(open(path, "rb").read()))
    producer = [v for f, _, v in fields if f == 2]
    return producer, [(f, w, v) for f, w, v in fields if f != 2]


class _BnOnnxExecutor(_OnnxExecutor):
    """The layout of the reference's torch exports: each conv without a bias,
    followed by a BatchNormalization node, and numeric initializer names."""

    def __init__(self, variables):
        super().__init__(None)
        self.v = variables

    def _init(self, a):
        name = str(len(self.initializers) + 100)
        self.initializers.append(_tensor(name, np.asarray(a, np.float32)))
        return name

    def _layer(self, name):
        p, s = self.v["params"], self.v["batch_stats"]
        for part in name.split("/"):
            p, s = p[part], s[part]
        return p, s

    def _conv_bn(self, x, name, kernel, stride, groups, pad, deconv=False):
        p, s = self._layer(name)
        k = p["kernel"].transpose(2, 3, 0, 1) if deconv else p["conv"]["kernel"].transpose(
            3, 2, 0, 1)
        attrs = [_attr_ints("dilations", (1, 1)), _attr_int("group", groups),
                 _attr_ints("kernel_shape", (kernel, kernel)), _attr_ints("pads", (pad,) * 4),
                 _attr_ints("strides", (stride, stride))]
        y = self._uniq(name)
        self.nodes.append(_node("ConvTranspose" if deconv else "Conv", [x, self._init(k)], [y],
                                name, attrs))
        bn = [self._init(a) for a in (p["bn"]["scale"], p["bn"]["bias"], s["bn"]["mean"],
                                      s["bn"]["var"])]
        out = self._uniq("bn")
        self.nodes.append(_node("BatchNormalization", [y, *bn], [out], out))
        return out

    def conv(self, x, name, kernel, stride=1, depthwise=False, act=True):
        groups = int(self._layer(name)[0]["conv"]["kernel"].shape[-1]) if depthwise else 1
        y = self._conv_bn(x, name, kernel, stride, groups, (kernel - 1) // 2)
        return self._relu(y) if act else y

    def deconv2x(self, x, name):
        return self._relu(self._conv_bn(x, name, 2, 2, 1, 0, deconv=True))

    def head(self, x, name):
        p = self.v["params"][name]
        return self._conv(x, name, 1, 1, 1, 0, self._init(p["kernel"].transpose(3, 2, 0, 1)),
                          self._init(p["bias"]))


def write_bn_onnx(variables, graph_arch, path):
    """An unfolded ONNX in the reference's torch-export layout."""
    num_out = int(variables["params"]["head_5"]["kernel"].shape[-1])
    return _serialize(_BnOnnxExecutor(variables), graph_arch, (256, 320), num_out, path)


# ----------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """For each arch: the zoo tree, its fold, and every artifact written by
    each package's writer (``port/`` and ``jax/``), the reference-layout
    ``.pth`` and the BN-preserved ONNX."""
    out = {}
    for arch, (zoo, cfg_name, graph) in ARCHS.items():
        variables = load_variables(zoo_path(zoo))
        folded = fold_batchnorm(variables)
        root = tmp_path_factory.mktemp(arch)
        for tag, mod, cfg, quant in (("port", P, get_config(cfg_name), quantize_weights),
                                     ("jax", J, jget_config(cfg_name), jquantize_weights)):
            d = root / tag
            d.mkdir()
            mod.save_native_weights(folded, str(d / "model.yfb"), io_config=cfg.io)
            mod.save_native_weights(quant(folded), str(d / "model_int8.yfb"), io_config=cfg.io)
            mod.export_onnx(folded, cfg.io.input_hw, str(d / "model.onnx"), arch=graph)
            mod.export_onnx_detect(folded, cfg, str(d / "detect.onnx"), arch=graph)
            mod.export_ncnn(folded, cfg.io.input_hw, str(d / "model.param"),
                            str(d / "model.bin"), arch=graph)
            mod.export_caffe(folded, cfg.io.input_hw, str(d / "model.prototxt"),
                             str(d / "model.caffemodel"), arch=graph)
        torch.save(variables_to_torch_state_dict(variables), str(root / "ref.pth"))
        write_bn_onnx(variables, graph, str(root / "ref_bn.onnx"))
        out[arch] = {"variables": variables, "folded": folded, "root": root, "graph": graph,
                     "cfg": cfg_name}
    return out


@pytest.fixture(scope="module")
def cli_export(exports, tmp_path_factory):
    """The port's ``export`` command on the 256x320 zoo: (directory, what it
    printed)."""
    import contextlib
    import io

    from yolofastest_torch.cli import main

    d = tmp_path_factory.mktemp("cli_export")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        assert main(["export", "--weights", zoo_path("256x320"), "--out", str(d)]) == 0
    return d, printed.getvalue()


@pytest.fixture(scope="module")
def epoch_dir(tmp_path_factory):
    """A port checkpoint (``epoch_1/``) of the 256x320 zoo tree."""
    from yolofastest_torch.train import Trainer

    trainer = Trainer(get_config("256x320"), batch_per_epoch=1,
                      variables=load_variables(zoo_path("256x320")), device="cpu")
    return trainer.save_checkpoint(str(tmp_path_factory.mktemp("ck")), 1)


# ------------------------------------------------------------------ writers
FILES = {"yfb": ["model.yfb"], "yfb_int8": ["model_int8.yfb"], "onnx": ["model.onnx"],
         "detect_onnx": ["detect.onnx"], "ncnn": ["model.param", "model.bin"],
         "caffe": ["model.prototxt", "model.caffemodel"]}


@pytest.mark.parametrize("fmt", list(FILES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_written_files_equal_jax(exports, arch, fmt):
    """Byte for byte; in ONNX the producer name (ModelProto field 2) names the
    port and nothing else differs."""
    root = exports[arch]["root"]
    for name in FILES[fmt]:
        ours, theirs = root / "port" / name, root / "jax" / name
        if name.endswith(".onnx"):
            (p_ours, rest_ours), (p_theirs, rest_theirs) = (_model_fields(ours),
                                                              _model_fields(theirs))
            assert (p_ours, p_theirs) == ([b"yolofastest_torch"], [b"yolofastest_tpu"])
            assert rest_ours == rest_theirs
            assert ours.stat().st_size - theirs.stat().st_size == 2  # the name, nothing else
        else:
            assert ours.read_bytes() == theirs.read_bytes(), name


@pytest.mark.parametrize("arch", list(ARCHS))
def test_yfb_reads_back_like_jax(exports, arch):
    """load_native_weights and read_native_meta on the port's .yfb files give
    what the JAX readers give, and the fp tensors are the fold."""
    d = exports[arch]["root"] / "port"
    for name in ("model.yfb", "model_int8.yfb"):
        ours, theirs = P.load_native_weights(str(d / name)), J.load_native_weights(str(d / name))
        assert sorted(ours) == sorted(theirs)
        for layer in ours:
            assert sorted(ours[layer]) == sorted(theirs[layer])
            for t in ours[layer]:
                np.testing.assert_array_equal(ours[layer][t], theirs[layer][t])
        assert P.read_native_meta(str(d / name)) == J.read_native_meta(str(d / name))
    folded = exports[arch]["folded"]
    back = P.load_native_weights(str(d / "model.yfb"))
    for layer in folded:
        np.testing.assert_array_equal(back[layer]["kernel"], folded[layer]["kernel"])
    assert P.read_native_meta(str(d / "model.yfb"))["input_hw"] == (256, 320)


# ------------------------------------------------------------------ imports
IMPORTS = [("onnx", "fastest"), ("onnx", "lite"), ("onnx_bn", "fastest"), ("onnx_bn", "lite"),
           ("ncnn", "fastest"), ("ncnn", "lite"), ("pth", "fastest"), ("pth", "lite")]


@pytest.mark.parametrize("kind,arch", IMPORTS, ids=[f"{k}-{a}" for k, a in IMPORTS])
def test_imports_equal_jax(exports, kind, arch):
    """The port's import of a file equals the JAX import of the same file,
    bit for bit, with the same arch and bn_preserved; the BN-preserved ONNX
    and the .pth give back the zoo tree itself."""
    from yolofastest_torch.models import unfold_to_variables
    from yolofastest_torch.models.torch_io import load_torch_checkpoint
    from yolofastest_tpu.models.torch_io import load_torch_checkpoint as jload_torch_checkpoint

    e = exports[arch]
    root = e["root"]
    if kind in ("onnx", "onnx_bn"):
        path = str(root / ("port/model.onnx" if kind == "onnx" else "ref_bn.onnx"))
        ours, theirs = P.import_onnx(path), J.import_onnx(path)
        assert ours[1:] == theirs[1:] == (e["graph"], kind == "onnx_bn")
        _assert_trees_equal(ours[0], theirs[0])
        _assert_trees_equal(ours[0], e["variables"] if kind == "onnx_bn"
                            else unfold_to_variables(e["folded"]))
    elif kind == "ncnn":
        path = str(root / "port/model.param")
        (ours, a1), (theirs, a2) = P.import_ncnn(path), J.import_ncnn(path)
        assert a1 == a2 == e["graph"]
        assert sorted(ours) == sorted(theirs) == sorted(e["folded"])
        for layer in ours:
            for t in ("kernel", "bias"):
                np.testing.assert_array_equal(ours[layer][t], theirs[layer][t])
                np.testing.assert_array_equal(ours[layer][t], e["folded"][layer][t])
    else:
        path = str(root / "ref.pth")
        ours = load_torch_checkpoint(path)
        _assert_trees_equal(ours, jload_torch_checkpoint(path))
        _assert_trees_equal(ours, e["variables"])


def _corrupt(exports, tmp_path, case):
    """(reader name, path) of one bad input, cut from the port's files."""
    d = exports["fastest"]["root"] / "port"

    def write(name, data):
        p = tmp_path / name
        p.write_bytes(data.encode() if isinstance(data, str) else data)
        return str(p)

    onnx, yfb = (d / "model.onnx").read_bytes(), (d / "model.yfb").read_bytes()
    param, weights = (d / "model.param").read_text(), (d / "model.bin").read_bytes()
    pth = (exports["fastest"]["root"] / "ref.pth").read_bytes()
    if case == "onnx-empty":
        return "onnx", write("e.onnx", b"")
    if case == "onnx-truncated":
        return "onnx", write("t.onnx", onnx[: len(onnx) // 2])
    if case == "onnx-random":
        return "onnx", write("r.onnx", np.random.default_rng(0).bytes(256))
    if case == "onnx-qdq":
        graph = _ld(1, _node("QuantizeLinear", ["input", "s", "z"], ["q"], "q"))
        return "onnx", write("q.onnx", _ld(7, graph + _s(2, "g")))
    if case == "ncnn-magic":
        write("m.bin", weights)
        return "ncnn", write("m.param", "7767518\n" + param.split("\n", 1)[1])
    if case == "ncnn-param-truncated":
        write("p.bin", weights)
        return "ncnn", write("p.param", "\n".join(param.splitlines()[:40]))
    if case == "ncnn-bin-truncated":
        write("b.bin", weights[:-100])
        return "ncnn", write("b.param", param)
    if case == "yfb-magic":
        return "yfb", write("m.yfb", b"YFWX" + yfb[4:])
    if case == "yfb-truncated":
        return "yfb", write("t.yfb", yfb[: len(yfb) // 3])
    if case == "pth-truncated":
        return "pth", write("t.pth", pth[: len(pth) // 2])
    return "pth", str(tmp_path / "missing.pth")


BAD = ["onnx-empty", "onnx-truncated", "onnx-random", "onnx-qdq", "ncnn-magic",
       "ncnn-param-truncated", "ncnn-bin-truncated", "yfb-magic", "yfb-truncated",
       "pth-truncated", "pth-missing"]


@pytest.mark.parametrize("case", BAD)
def test_bad_input_fails_like_jax(exports, tmp_path, case):
    from yolofastest_torch.models.torch_io import load_torch_checkpoint
    from yolofastest_tpu.models.torch_io import load_torch_checkpoint as jload_torch_checkpoint

    reader, path = _corrupt(exports, tmp_path, case)
    fns = {"onnx": (P.import_onnx, J.import_onnx), "ncnn": (P.import_ncnn, J.import_ncnn),
           "yfb": (P.load_native_weights, J.load_native_weights),
           "pth": (load_torch_checkpoint, jload_torch_checkpoint)}[reader]
    raised = []
    for fn in fns:
        with pytest.raises(Exception) as info:
            fn(path)
        raised.append(type(info.value))
    assert raised[0] is raised[1], raised
    if case == "onnx-qdq":
        with pytest.raises(ValueError, match="QDQ"):
            P.import_onnx(path)


# -------------------------------------------------------------- torchscript
@pytest.mark.parametrize("arch", list(ARCHS))
def test_torchscript_heads_match_jax(exports, cli_export, arch):
    """build_torch_module against JAX's on the same input (1e-6); for
    256x320 also the export command's model.pt loaded by torch.jit."""
    from yolofastest_tpu.export import build_torch_module as jbuild_torch_module

    folded, graph = exports[arch]["folded"], exports[arch]["graph"]
    x = torch.from_numpy(_golden_x(2))
    with torch.no_grad():
        heads = [P.build_torch_module(folded, graph)(x), jbuild_torch_module(folded, graph)(x)]
        if arch == "fastest":
            heads.append(torch.jit.load(str(cli_export[0] / "model.pt"))(x))
    ours, theirs, *loaded = (h if isinstance(h, tuple) else (h,) for h in heads)
    assert len(ours) == len(theirs) == (2 if arch == "fastest" else 1)
    for got in [ours, *loaded]:
        assert len(got) == len(theirs)
        for a, b in zip(got, theirs):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# ----------------------------------------------------------------- commands
def test_cli_export_writes_jax_files(exports, cli_export):
    """export: JAX's file list minus the JAX programs (and a line saying so),
    the same bytes as the JAX writers' (ONNX: the producer name aside)."""
    d, printed = cli_export
    assert sorted(os.listdir(d)) == sorted(JAX_EXPORT_FILES)
    assert all(name in printed for name in JAX_PROGRAM_FILES)
    theirs = exports["fastest"]["root"] / "jax"
    for name in JAX_EXPORT_FILES[:-1]:
        if name.endswith(".onnx"):
            assert _model_fields(d / name)[1] == _model_fields(theirs / name)[1]
        else:
            assert (d / name).read_bytes() == (theirs / name).read_bytes(), name


def test_cli_export_refusals(exports, tmp_path, capsys):
    """The int8 branch of ``export`` (the lite zoo at a 64x96 config): a
    missing --calib-data directory and --qat-steps without calibration each
    print their line and still write the fp files, without the int8 extras;
    --calib-data with images writes them and names forward_int8.stablehlo
    among the JAX programs; a lite ONNX under --arch fastest stops as the JAX
    command does."""
    import dataclasses

    from yolofastest_torch.cli import main

    cfg = get_config("lite-256x320")
    cfgj = tmp_path / "tiny.json"
    cfgj.write_text(dataclasses.replace(cfg, io=dataclasses.replace(
        cfg.io, input_shape=(64, 96, 1))).to_json())
    data = tmp_path / "data"
    data.mkdir()
    cv2 = pytest.importorskip("cv2")
    cv2.imwrite(str(data / "im0.jpg"), np.random.default_rng(0).integers(0, 255, (64, 96, 3),
                                                                         np.uint8))
    base = ["export", "--config-json", str(cfgj), "--arch", "lite", "--weights",
            zoo_path("lite_256x320"), "--device", "cpu"]
    fp_files = ["detect.onnx", "model.bin", "model.caffemodel", "model.onnx", "model.param",
                "model.prototxt", "model.pt", "model.yfb", "model_int8.yfb"]
    missing = str(tmp_path / "missing")
    assert main(base + ["--out", str(tmp_path / "a"), "--calib-data", missing,
                        "--qat-steps", "3"]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[:2] == [f"no calibration images (.jpg/.png/.bmp) in {missing}",
                           "--qat-steps needs --calib-data (skipping QAT)"]
    assert sorted(os.listdir(tmp_path / "a")) == fp_files
    assert "and detect.mlir are JAX programs" in printed[-1]
    assert main(base + ["--out", str(tmp_path / "b"), "--calib-data", str(data)]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert sorted(os.listdir(tmp_path / "b")) == sorted(fp_files + ["model.table",
                                                                    "model_int8.onnx"])
    assert "forward_int8.stablehlo are JAX programs" in printed[-1]
    with pytest.raises(SystemExit, match="single-head"):
        main(["export", "--weights", str(exports["lite"]["root"] / "port/model.onnx"), "--out",
              str(tmp_path / "o")])


CONVERT = ["pth", "onnx", "onnx_bn", "ncnn", "epoch_dir"]


@pytest.mark.parametrize("source", CONVERT)
def test_cli_convert_matches_jax(exports, epoch_dir, tmp_path, capsys, source):
    """convert writes the .npz the JAX command writes from the same file
    (a port checkpoint directory: the .npz of its variables), with JAX's
    notes."""
    from yolofastest_torch.cli import main
    from yolofastest_tpu.cli import main as jmain

    root = exports["fastest"]["root"]
    flag, path = {"pth": ("--pth", root / "ref.pth"), "onnx": ("--onnx", root / "port/model.onnx"),
                  "onnx_bn": ("--onnx", root / "ref_bn.onnx"),
                  "ncnn": ("--ncnn", root / "port/model.param"),
                  "epoch_dir": ("--pth", epoch_dir)}[source]
    assert main(["convert", flag, str(path), "--out", str(tmp_path / "ours.npz")]) == 0
    ours = capsys.readouterr().out
    if source == "epoch_dir":  # the JAX command reads orbax directories, not the port's
        _assert_trees_equal(load_variables(str(tmp_path / "ours.npz")), exports["fastest"]
                            ["variables"])
        return
    assert jmain(["convert", flag, str(path), "--out", str(tmp_path / "theirs.npz")]) == 0
    theirs = capsys.readouterr().out
    assert ours.replace("ours.npz", "theirs.npz") == theirs
    _assert_trees_equal(load_variables(str(tmp_path / "ours.npz")),
                        load_variables(str(tmp_path / "theirs.npz")))


def test_cli_convert_refusals(tmp_path, capsys):
    from yolofastest_torch.cli import main

    assert main(["convert", "--out", str(tmp_path / "o.npz")]) == 2
    assert main(["convert", "--pth", "a.pth", "--onnx", "b.onnx", "--out", "o.npz"]) == 2
    assert main(["convert", "--pth", str(tmp_path), "--out", str(tmp_path / "o.npz")]) == 2
    assert "exactly one" in capsys.readouterr().out
    assert not os.path.exists(tmp_path / "o.npz")


# ------------------------------------------------------------ consumer tools
@pytest.mark.parametrize("tool", ["onnx", "ncnn", "caffe"])
def test_consumer_tools_accept_port_files(exports, tmp_path, tool):
    """tools/<tool>_check.py (numpy only) runs the port's 256x320 files to the
    heads of the port's folded forward (1e-4)."""
    import importlib

    from yolofastest_torch.models import folded_apply, torch_params_from_folded

    d = exports["fastest"]["root"] / "port"
    x = _golden_x(1)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        check = importlib.import_module(f"{tool}_check")
    finally:
        sys.path.pop(0)
    if tool == "onnx":  # its main() also checks that no torch is loaded: in-process here
        nodes, init, g_in, g_out = check.load_model(str(d / "model.onnx"))
        env = check.run(nodes, init, {g_in[0]: x})
        got = {name: env[name] for name in g_out}
    else:
        np.save(tmp_path / "x.npy", x)
        files = ["model.param", "model.bin"] if tool == "ncnn" else ["model.prototxt",
                                                                     "model.caffemodel"]
        check.main(["check", *(str(d / f) for f in files), str(tmp_path / "x.npy"),
                    str(tmp_path / "y.npz")])
        got = np.load(tmp_path / "y.npz")
    params = torch_params_from_folded(exports["fastest"]["folded"], torch.device("cpu"))
    heads = folded_apply(params, torch.from_numpy(x.transpose(0, 2, 3, 1)))
    for name, h in zip(("head_large", "head_small"), heads):
        np.testing.assert_allclose(got[name], h.numpy().transpose(0, 3, 1, 2), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------- detect against the JAX command
_DETECT = {}


def detect_inputs():
    """Made once per process, in a temporary directory removed at exit: two
    golden frames as .jpg and one as .png, and a config JSON with other
    class names and a lower confidence threshold."""
    import dataclasses

    if not _DETECT:
        root = tempfile.mkdtemp(prefix="yf_torch_export_")
        atexit.register(shutil.rmtree, root, True)
        data = os.path.join(root, "data")
        os.makedirs(data)
        fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
        for name, frame in zip(("g0.jpg", "g1.jpg", "g2.png"), make_frames(fx["pre_imgs"][:3])):
            cv2.imwrite(os.path.join(data, name), frame)
        cfg = get_config("256x320")
        cfg = dataclasses.replace(cfg, io=dataclasses.replace(
            cfg.io, conf_thre=0.3, class_names=("ship_a", "ship_b", "ship_c")))
        cfg_json = os.path.join(root, "cfg.json")
        with open(cfg_json, "w") as f:
            f.write(cfg.to_json())
        _DETECT.update(root=root, data=data, cfg_json=cfg_json)
    return _DETECT


DETECT_RUNS = {  # name: (the JAX command's flags, the port's extra flags)
    "config_json": (["--config-json", "{cfg_json}"], []),
    "fold_bn_sliced": (["--fold-bn", "--sliced", "2x2"], ["--backend", "jax"]),
}


class _RecordDrawn:
    """Within the block, record each box the detect command draws (corners
    and label) through ``visualize.plot_one_box`` and ``module``'s copy."""

    def __init__(self, module, visualize):
        self.modules, self.plot, self.drawn = (module, visualize), visualize.plot_one_box, []

    def __enter__(self):
        def record(xyxy, img, color=None, label=None, line_thickness=None):
            self.drawn.append(([float(v) for v in xyxy], label))
            return self.plot(xyxy, img, color=color, label=label, line_thickness=line_thickness)

        for m in self.modules:
            m.plot_one_box = record
        return self.drawn

    def __exit__(self, *exc):
        for m in self.modules:
            m.plot_one_box = self.plot


def _image_lines(out):
    """The per-image lines of detect_info.log without their times."""
    lines = open(os.path.join(out, "detect_info.log")).read().splitlines()
    return [re.sub(r"[0-9.]+ms", "", ln.split("——", 1)[1]) for ln in lines if "image_name:" in ln]


def _jax_detect(data, out, flags):
    """The JAX detect command on the zoo 256x320 weights: its exit code,
    the boxes it drew, its per-image log lines and its files."""
    from yolofastest_tpu.cli import main as jmain
    from yolofastest_tpu.inference import detector as jdetector
    from yolofastest_tpu.utils import visualize as jvisualize

    with _RecordDrawn(jdetector, jvisualize) as drawn:
        rc = jmain(["detect", "--weights", zoo_path("256x320"), "--data", data, "--out", out,
                    *flags])
    return rc, drawn, _image_lines(out), sorted(os.listdir(out))


def _detect_args(name):
    inp = detect_inputs()
    flags = [f.format(**inp) for f in DETECT_RUNS[name][0]]
    return inp["data"], os.path.join(inp["root"], f"jax_{name}"), flags


for _name in DETECT_RUNS:
    register(f"export/detect_{_name}", _jax_detect, lambda n=_name: _detect_args(n))


@pytest.mark.parametrize("name", list(DETECT_RUNS))
def test_cli_detect_matches_jax_command(jax_refs, epoch_dir, tmp_path, name):  # noqa: F811
    """The port's detect against the JAX command on the same files: a port
    checkpoint directory where JAX reads the .npz of the same variables
    (and the port's .npz run writes the same images as its directory run),
    --config-json, --fold-bn either way (the trainable graph without it),
    --backend jax, and --sliced over the .jpg files only.  Boxes within 1 px,
    labels' scores within 0.01 (two decimals printed), classes and per-image
    lines equal."""
    from yolofastest_torch.cli import main
    from yolofastest_torch.inference import detector as tdetector
    from yolofastest_torch.utils import visualize as tvisualize

    inp = detect_inputs()
    jflags, extra = DETECT_RUNS[name]
    flags = [f.format(**inp) for f in jflags] + extra + ["--device", "cpu"]
    out = str(tmp_path / "out")
    with _RecordDrawn(tdetector, tvisualize) as drawn:
        assert main(["detect", "--weights", epoch_dir, "--data", inp["data"], "--out", out,
                     *flags]) == 0
    if name == "config_json":
        npz_out = str(tmp_path / "npz")
        assert main(["detect", "--weights", zoo_path("256x320"), "--data", inp["data"],
                     "--out", npz_out, *flags]) == 0
        for f in os.listdir(out):
            if f.startswith("result_"):
                np.testing.assert_array_equal(cv2.imread(os.path.join(out, f)),
                                              cv2.imread(os.path.join(npz_out, f)))
    rc, jdrawn, jlines, jfiles = jax_refs[f"export/detect_{name}"]
    assert rc == 0
    assert sorted(os.listdir(out)) == jfiles
    assert _image_lines(out) == jlines
    assert len(drawn) == len(jdrawn) > 0
    for (box, label), (jbox, jlabel) in zip(drawn, jdrawn):
        assert label.split()[0] == jlabel.split()[0]
        assert abs(float(label.split()[1]) - float(jlabel.split()[1])) <= 0.0101
        np.testing.assert_allclose(box, jbox, atol=1.0)
    if name == "fold_bn_sliced":
        assert jfiles == ["detect_info.log", "result_g0.jpg", "result_g1.jpg"]
    else:
        assert "result_g2.png" in jfiles
    if name == "config_json":
        assert all(label.split()[0].startswith("ship_") for _, label in drawn)


def test_cli_detect_rejects_unported_backends(tmp_path, capsys):
    """Every backend is ported now (the native ones in
    tests/test_torch_native.py); with no images to calibrate on and no cache
    the int8 ones and native-int8 exit 2 with the JAX commands' messages,
    before any engine is made."""
    from yolofastest_torch.cli import main

    base = ["--weights", zoo_path("256x320"), "--device", "cpu", "--calibration-cache",
            str(tmp_path / "c.json")]
    assert main(["detect", *base, "--data", str(tmp_path), "--out", str(tmp_path / "o"),
                 "--backend", "native-int8"]) == 2
    assert f"no calibration images (.jpg/.png/.bmp) in {tmp_path}" in capsys.readouterr().out
    assert main(["video", *base, "--video", "v.avi", "--out", str(tmp_path / "o"),
                 "--backend", "native-int8"]) == 2
    err = capsys.readouterr().err
    assert "native-int8 calibration needs images: pass a data/--calib-data" in err
    for backend in ("int8", "int8-fused"):
        assert main(["detect", *base, "--data", str(tmp_path), "--out", str(tmp_path / "o"),
                     "--backend", backend]) == 2
        assert f"no calibration images (.jpg/.png/.bmp) in {tmp_path}" in capsys.readouterr().out
        assert main(["video", *base, "--video", "v.avi", "--out", str(tmp_path / "o"),
                     "--backend", backend]) == 2
        err = capsys.readouterr().err
        assert "int8 calibration needs images: pass --calib-data" in err and "ROADMAP" not in err
    assert not os.path.exists(tmp_path / "c.json")
