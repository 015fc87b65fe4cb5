"""`utils.profiling.trace` on the card, many times over: does the trace hold
every kernel the block launched?

Each run is `chip_smoke.py`'s `profile` block: a `run_raw` of the 256x320
Detector at B=8 and one fp32 train step at B=8, run once unsynchronised (so
that work is queued when the trace starts), then again inside the trace.
The written trace's chain and NMS kernel events are held against the
launch counters (6 and 1), and every kernel launch the trace records
(`cudaLaunchKernel*`, `cuLaunchKernel*`) against the kernel events: a
launch without its kernel is lost.  The median gap between a kernel's start
and its launch (the card's clock converted to the host's) shows the
conversion's offset.  Two forms run in turns: `trace` (the repo's) and
`parent` (the profiler started and stopped around the block with nothing
else, the repo's earlier form).

    python3 tools/torch_trace_check.py [--runs 12] [--after-smoke]

`--after-smoke` first runs every phase of `chip_smoke.py` in this process
and the loop in place of its `profile` phase (the traces that lost events
came at the end of that script), then the script's own `profile` phase.
One JSON line a run, then a summary line.  Needs a CUDA card; builds the
kernels.
"""

import argparse
import contextlib
import glob
import json
import os
import statistics
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LAUNCH_NAMES = ("cudaLaunchKernel", "cuLaunchKernel")


@contextlib.contextmanager
def parent_trace(log_dir):
    """The profiler around the block and nothing else (the earlier form)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        try:
            yield prof
        finally:
            torch.cuda.synchronize()


def read_trace(path):
    """Chain and NMS kernel events, lost launches and the median gap."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name", "").startswith(LAUNCH_NAMES)
                and "correlation" in e.get("args", {})}
    seen = {e.get("args", {}).get("correlation") for e in kernels}
    in_order = sorted(launches, key=launches.get)
    gaps = [e["ts"] - launches[e["args"]["correlation"]] for e in kernels
            if e.get("args", {}).get("correlation") in launches]
    return {"chain": sum("res_chain_kernel" in e["name"] for e in kernels),
            "nms": sum("nms_packed" in e["name"] for e in kernels),
            "kernel_events": len(kernels), "launches_recorded": len(launches),
            "lost": sum(c not in seen for c in in_order),
            "lost_launch_positions": [i for i, c in enumerate(in_order) if c not in seen][:8],
            "median_gap_us": round(statistics.median(gaps), 1) if gaps else None}


def loop(runs: int) -> dict:
    import numpy as np
    import torch

    import chip_smoke as cs
    from yolofastest_torch.configs import get_config
    from yolofastest_torch.inference import Detector
    from yolofastest_torch.kernels import LAUNCHES
    from yolofastest_torch.kernels import res_block as rb
    from yolofastest_torch.train import Trainer
    from yolofastest_torch.utils.profiling import trace

    cfg, zoo, x, t = cs.parallel_inputs()
    det = Detector(get_config("256x320"), variables=zoo, device="cuda")
    golden = np.load(os.path.join(cs.FIXTURES, "golden_256x320.npz"))
    frames = cs.make_frames(golden["pre_imgs"][:8])
    trainer = Trainer(cfg, batch_per_epoch=1, variables=zoo, device="cuda")
    forms = {"trace": trace, "parent": parent_trace}
    records = {name: [] for name in forms}
    for i in range(runs):
        for name, form in forms.items():
            det.run_raw(frames)
            trainer.step(x[:8], t[:8])
            with tempfile.TemporaryDirectory() as td:
                rb.reset_launch_counts()
                with form(td):
                    det.run_raw(frames)
                    trainer.step(x[:8], t[:8])
                torch.cuda.synchronize()
                launches = dict(LAUNCHES)
                rec = {"form": name, "run": i, **read_trace(glob.glob(
                    os.path.join(td, "*.pt.trace.json"))[0]), "launches": launches}
            rec["exact"] = (rec["chain"], rec["nms"]) == (launches["res_chain_rows"],
                                                          launches["nms"]) == (6, 1)
            records[name].append(rec)
            print(json.dumps(rec), flush=True)
    summary = {name: {"runs": len(r), "exact": sum(x["exact"] for x in r),
                      "chain": [x["chain"] for x in r], "lost": [x["lost"] for x in r]}
               for name, r in records.items()}
    print("TRACE_CHECK " + json.dumps(summary), flush=True)
    return summary


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--after-smoke", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_trace_check: needs a CUDA card", file=sys.stderr)
        return 2
    if not args.after_smoke:
        from yolofastest_torch.kernels import _build

        _build.build()
        loop(args.runs)
        return 0
    import chip_smoke as cs

    profile_path = cs.profile_path

    def looped(card, counted):
        loop(args.runs)
        return profile_path(card, counted)

    cs.profile_path = looped
    return cs.main()


if __name__ == "__main__":
    sys.exit(main())
