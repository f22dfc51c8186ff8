"""Run chosen phases of one tree's chip_smoke.py, for comparing two trees
on one card.

    python tools/run_phases.py [--tree DIR] [--json-out FILE] PHASE...

`--tree` is the root of a checkout (default: this one): its
`chip_smoke.py` supplies the phases (`serve_phase`, `engine_phase`,
`train_phase`, `kernel_phase`, ...) and its `src/repro_torch` the code
they run; the kernels build into that tree's own `.repro_torch_build/`.
Each phase runs as `chip_smoke.main` runs it (the same backend settings,
its arguments by name), with the kernel rows of the phases before it;
a failing phase is reported and the next one runs.  Prints the card's
name and power limit, each phase's own lines and its time, and exits 1
if a phase failed.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--json-out", default=None)
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]

    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("run_phases: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    smi = cs._nvidia_smi()
    print(smi)
    print(f"[phases] tree {tree}: {len(build.SOURCES)} libraries ready in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    kind = torch.cuda.get_device_name(0)
    given = {"torch": torch, "smi": smi, "record": {"phase_s": {}},
             "peaks": cs.PEAKS["pcie" if "pcie" in kind.lower() else "sxm"],
             "rows": []}
    failed = []
    for name in args.phases:
        phase = getattr(cs, name)
        kw = {p: given[p] for p in inspect.signature(phase).parameters}
        t = time.perf_counter()
        try:
            out = phase(**kw)
            torch.cuda.synchronize()
        except Exception:
            traceback.print_exc()
            failed.append(name)
            print(f"[phases] {name} FAILED", flush=True)
            continue
        if name.endswith("kernel_phase"):
            given["rows"] += out
        s = given["record"]["phase_s"][name] = time.perf_counter() - t
        print(f"[time] {name}: {s:.2f}s", flush=True)
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(
            dict(given["record"], rows=given["rows"], tree=str(tree),
                 device=smi, failed=failed), indent=1, default=str))
    print(smi)
    if failed:
        raise SystemExit(f"run_phases: failed {failed}")


if __name__ == "__main__":
    main()
