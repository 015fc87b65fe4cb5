"""The sets of ``tests/test_torch_finetune.py``, made in a process of its
own.

:func:`run` writes to its directory the golden frames as lossless files
under their ``image_names`` (``ref/``, the input JAX's tool copies), then,
for both sizes at ``--copies 2``, JAX's ``tools/make_finetune_set.py``
(``REF_DATA`` pointed at ``ref/``) into ``jax_<res>/`` and the port's
``tools/torch_make_finetune_set.py`` into ``port_<res>/`` (the 512x640 set
twice, the second time over the first), and ``done.json`` last (``{"ok":
true, "printed": [the port tool's lines]}``, or the traceback).

``tests/_background.py`` starts it with the first port module, at ``nice
10``.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
RESOLUTIONS = ("256x320", "512x640")


def _module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(root: str) -> None:
    try:
        import cv2
        import numpy as np

        frames = np.load(os.path.join(ROOT, "tests", "fixtures", "golden_512x640.npz"))
        ref = os.path.join(root, "ref")
        os.makedirs(ref)
        for name, img in zip(frames["image_names"], frames["pre_imgs"]):
            with open(os.path.join(ref, str(name)), "wb") as f:
                f.write(cv2.imencode(".png", img)[1].tobytes())
        jax_tool = _module(os.path.join(TOOLS, "make_finetune_set.py"), "jax_make_finetune_set")
        jax_tool.REF_DATA = ref
        port_tool = _module(os.path.join(TOOLS, "torch_make_finetune_set.py"),
                            "torch_make_finetune_set")
        printed = io.StringIO()
        for res in RESOLUTIONS:
            sys.argv = ["make_finetune_set.py", "--out", os.path.join(root, f"jax_{res}"),
                        "--copies", "2", "--res", res]
            with contextlib.redirect_stdout(io.StringIO()):
                jax_tool.main()
            with contextlib.redirect_stdout(printed):
                for _ in range(1 + (res == "512x640")):
                    port_tool.main(["--out", os.path.join(root, f"port_{res}"), "--copies", "2",
                                    "--res", res])
        done = {"ok": True, "printed": printed.getvalue().splitlines()}
    except Exception:  # noqa: BLE001 (the reader reports it)
        done = {"ok": False, "error": traceback.format_exc()}
    with open(os.path.join(root, "done.json"), "w") as f:
        json.dump(done, f)
