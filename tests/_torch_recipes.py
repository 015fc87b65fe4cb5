"""The port's side of ``tests/test_torch_recipes.py``, made in a process of
its own.

:func:`run` (no JAX) writes to its directory:

* ``matrix.json``: ``run_resolution("256x320")`` on the first
  :data:`MATRIX_FRAMES` golden frames on the CPU, the native rows where a
  native library exists (``native`` says whether);
* ``int8/yolofastest_int8_512x640.npz``: ``build_shipped("512x640")`` on
  the CPU;
* ``lite_seed.npz``: ``tools/torch_make_lite_seed.py --out``;
* ``done.json`` last (``{"ok": true}``, or the traceback).

``tests/_background.py`` starts it with the first port module, at ``nice
10`` with two torch threads.
"""

import json
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATRIX_FRAMES = 2
THREADS = 2


def run(root: str) -> None:
    import torch

    torch.set_num_threads(THREADS)
    try:
        from yolofastest_torch.eval.golden_suite import run_resolution
        from yolofastest_torch.native import available_library
        from yolofastest_torch.quant.recipes import build_shipped

        native = available_library() is not None
        matrix = run_resolution("256x320", os.path.join(root, "matrix"), "cpu",
                                frames=MATRIX_FRAMES, native=native, log=lambda _: None)
        with open(os.path.join(root, "matrix.json"), "w") as f:
            json.dump({"native": native, "rows": matrix}, f)
        build_shipped("512x640", os.path.join(root, "int8", "yolofastest_int8_512x640.npz"),
                      "cpu", log=lambda _: None)
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        import torch_make_lite_seed

        torch_make_lite_seed.main(["--out", os.path.join(root, "lite_seed.npz")])
        done = {"ok": True}
    except Exception:  # noqa: BLE001 (the reader reports it)
        done = {"ok": False, "error": traceback.format_exc()}
    with open(os.path.join(root, "done.json"), "w") as f:
        json.dump(done, f)
