"""Readings that the comparison limits are set from, on the card.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 --mode sound
    python3 benchmark/control.py --workload <name> --seeds 11,12,13 --mode control
    python3 benchmark/control.py --workload <name> --seeds 11,12,13 --mode fault:<fault>

Runs the cell once a seed in one process, with a short window
(``--seconds``, default 1: one call), and prints each run's checks as a
JSON line. ``sound`` runs the cell as configured (the lower readings);
``control`` runs the program in the next precision below the
configuration's (the cell's ``control`` entry in ``workloads/<name>.json``:
configuration overrides, ``tf32`` to let float32 products run in TF32,
``vggish_fp8`` to put a float8 VGGish in the program's place);
``fault:<name>`` plants one of ``faults.py``'s faults. The benchmark's own
runs never run these.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import faults, harness  # noqa: E402


def fp8_vggish(stage):
    """The plain reference VGGish with every conv and dense layer's input
    and weight rounded to float8 e4m3 (scaled per tensor to its range), in
    the program's place: the control of a bf16 VGGish, which the program
    has no int8 path for."""
    import torch
    from torch import nn

    from benchmark import weights as W
    from benchmark.reference.vggish import VggishTaps

    def fp8(t):
        scale = t.abs().amax().clamp(min=1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale

    dev = stage.ctx.device
    state = W.make_state_dict(W.reference_on_meta(VggishTaps), stage.ctx.subseed("layer_vggish"),
                              dev)
    model = W.load_into(W.reference_on_meta(VggishTaps), state, dev)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Conv2d, nn.Linear)):
                mod.weight.copy_(fp8(mod.weight))
                mod.register_forward_pre_hook(lambda m, args: (fp8(args[0]),))
    model.media_type = "audio"
    model.model_tag = stage.models["layer_vggish"].model_tag
    stage.models["layer_vggish"] = model


def tf32(stage):
    """float32 products in TF32 for the window (reset after the run)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True


def mode_setup(workload: str, mode: str):
    """(configuration overrides, stage hooks) of a mode: ``sound``,
    ``control`` (the cell's entry in ``workloads/<cell>.json``) or
    ``fault:<name>``."""
    if mode == "sound":
        return {}, []
    if mode == "control":
        control = harness.read_json(harness.BENCH / "workloads" / f"{workload}.json")["control"]
        hooks = ([tf32] if control.get("tf32") else []) + (
            [fp8_vggish] if control.get("vggish_fp8") else [])
        return {"config": control.get("config", {})}, hooks
    if mode.startswith("fault:"):
        stage = harness.load_cell(workload).traffic["stage"]
        return {}, [faults.FAULTS[stage][mode.split(":", 1)[1]]]
    raise SystemExit(f"unknown mode {mode!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="sound")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    overrides, hooks = mode_setup(args.workload, args.mode)
    seen = {}

    def hook(stage):
        seen["stage"] = stage
        for h in hooks:
            h(stage)

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        try:
            result = harness.run_cell(args.workload, seed, args.seconds, False, t0,
                                      overrides=overrides, stage_hook=hook)
            line = {"seed": seed, "correct": result["correct"],
                    "checks": {k: v["value"] for k, v in result["checks"].items()},
                    "detail": getattr(seen.get("stage"), "detail", None)}
        except Exception as e:  # a control that crashes has failed; say how
            line = {"seed": seed, "error": f"{type(e).__name__}: {e}"}
        import torch

        torch.backends.cuda.matmul.allow_tf32 = False
        line.update(workload=args.workload, mode=args.mode,
                    seconds=round(time.perf_counter() - t0, 1))
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
