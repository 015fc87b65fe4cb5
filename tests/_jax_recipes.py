"""``tools/make_lite_seed.py --out DIR/jax_lite_seed.npz`` for
``tests/test_torch_recipes.py``, in a process of its own.

``python -m tests._jax_recipes DIR`` runs the JAX tool as its command line
runs it (``runpy``, ``__main__``).  Most of its ~50 s of CPU is XLA
compiling flax's init op by op; ``tests/_background.py`` starts it with the
first port module, at ``nice 19``, with XLA's backend optimisation off
(~27 s of CPU): every leaf the tool writes is copied from the full
checkpoint (none is kept from the init), so the file does not depend on
how XLA compiled the init.  In the pool of ``tests/_jax_refs.py`` it came
last and its reader waited ~24 s for it.
"""

import os
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XLA_FLAGS = "--xla_backend_optimization_level=0 --xla_llvm_disable_expensive_passes=true"


def main(root: str) -> None:
    sys.argv = ["make_lite_seed.py", "--out", os.path.join(root, "jax_lite_seed.npz")]
    runpy.run_path(os.path.join(ROOT, "tools", "make_lite_seed.py"), run_name="__main__")


if __name__ == "__main__":
    main(sys.argv[1])
