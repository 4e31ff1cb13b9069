"""Stage 4 with SLOWFAST_NLN_8x8_R50: ``run_extraction`` on ``layer_slowfast_nln``
and ``layer_vggish``, everything else as ``stages/extract.py`` (whose
traffic, window loop and check this reuses).

The video model is the configuration's ``models.layer_slowfast_nln``: the
program's ``layer_slowfast_nln`` with the configuration's non-local
``location`` (lists of slow-pathway blocks of s2..s5; empty lists take the
blocks out, on the same weights), checked against
``reference/slowfast_nln.py`` with the published location, whatever the
program runs. Weights: ``weights.make_state_dict`` over the reference, each
non-local block's BN scale taken from [0.8, 1.2] to [0.1, 0.3], the range
``weights.py`` gives a residual branch's last norm (it finds those by the
name ``c_bn``); then each block's conv biases centre theta, phi and g and its
BN statistics are its input's over the first ``calibration_clips`` of the
seed's clips (``calibrate_nonlocal``). The program and the check take the
same tensors. The rows' ``model_key`` is ``layer_slowfast_nln``.

``computation.slowfast_fp8`` (the cell's control) puts the plain reference
in the program's place with every conv's input and weight rounded to float8
e4m3 (scaled per tensor to its range), the next precision below bf16.
"""

from __future__ import annotations

import math
import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from benchmark import weights as W
from benchmark.reference import slowfast_nln as R
from benchmark.reference.vggish import VggishTaps
from benchmark.stages import extract

VIDEO = "layer_slowfast_nln"


def fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


class Stage(extract.Stage):
    def setup(self) -> None:
        from acav100m_torch.models import get_model

        cls = get_model(VIDEO)  # a program without the model fails here, at once
        self.make_traffic()
        dev = self.ctx.device
        self.sf_state = self.nln_state()
        location = self.ctx.config["models"][VIDEO]["nonlocal"]["location"]
        if self.comp.get("slowfast_fp8"):
            video = self.fp8_reference()
        else:
            with torch.device("meta"):
                video = cls(
                    dtype=self.comp["dtype"], pallas_stages=self.comp["pallas_stages"],
                    fast_block=self.comp["fast_block"], quant=self.comp["quant"],
                    nonlocal_location=location)
            keys = set(video.state_dict())
            video = W.load_into(video, {k: v.to(dev) for k, v in self.sf_state.items()
                                        if k in keys}, dev)
        self.models = {"layer_vggish": self.vggish(), VIDEO: video}
        # warm-up: one short call (one batch) at the cell's shapes
        self._extract(self.shards[-1][0], self.ctx.work / "warmup")

    def vggish(self) -> nn.Module:
        from acav100m_torch.models import get_model

        with torch.device("meta"):
            model = get_model("layer_vggish")(dtype=self.comp["dtype"])
        state = W.make_state_dict(W.reference_on_meta(VggishTaps),
                                  self.ctx.subseed("layer_vggish"), self.ctx.device)
        return W.load_into(model, state, self.ctx.device)

    def nln_state(self) -> Dict[str, torch.Tensor]:
        """The reference's seeded weights, the non-local blocks' set over the
        first calibration clips; kept on the host."""
        dev = self.ctx.device
        ref = W.reference_on_meta(R.SlowFastNlnTaps)
        state = W.make_state_dict(ref, self.ctx.subseed(VIDEO), dev)
        for key in state:
            if "_nonlocal" in key and key.endswith(".bn.weight"):
                state[key] = 0.1 + (state[key] - 0.8) / 2
        ref = W.load_into(ref, state, dev)
        R.calibrate_nonlocal(ref, torch.from_numpy(
            self.frames[:self.t["calibration_clips"]]).to(dev))
        state = {k: v.detach().cpu() for k, v in ref.state_dict().items()}
        del ref
        if self.ctx.cuda:
            torch.cuda.empty_cache()
        return state

    def fp8_reference(self) -> nn.Module:
        dev = self.ctx.device
        model = W.load_into(W.reference_on_meta(R.SlowFastNlnTaps),
                            {k: v.to(dev) for k, v in self.sf_state.items()}, dev)
        with torch.no_grad():
            for mod in model.modules():
                if isinstance(mod, nn.Conv3d):
                    mod.weight.copy_(fp8(mod.weight))
                    mod.register_forward_pre_hook(lambda m, args: (fp8(args[0]),))
        model.media_type = "video"
        model.model_tag = {"name": "SLOWFAST_NLN_8x8_R50", "dataset": "kinetics-400"}
        return model

    def count_units(self, calls: int) -> Tuple[int, int]:
        """(clips written, clips attempted); keeps the check's sample."""
        rng = np.random.default_rng(self.ctx.subseed("check"))
        per_call = math.ceil(self.t["check_rows"] / max(calls, 1))
        units = 0
        for shard, out in self.calls:
            path, names, clips = self.shards[shard]
            by_name = {}
            pkl = out / f"{path.stem}.pkl"
            rows = pickle.loads(pkl.read_bytes()) if pkl.is_file() else []
            for row in rows:
                by_name.setdefault(row["filename"], []).append(row)
            good = [nm for nm in names if len(by_name.get(nm, ())) == 1]
            self.wrong += len(names) - len(good) + sum(
                len(v) for k, v in by_name.items() if k not in set(names))
            units += len(good)
            member = {nm: clip for nm, clip in zip(names, clips)}
            for j in rng.choice(len(good), size=min(per_call, len(good)), replace=False):
                row = by_name[good[j]][0]
                taps = []
                for side, key in (("video_features", VIDEO), ("audio_features", "layer_vggish")):
                    feat = next(f for f in row[side] if f["model_key"] == key)
                    taps += [np.asarray(feat["array"][f"layer_{k}"]) for k in range(5)]
                self.sample.append((good[j], member[good[j]], taps))
        return units, len(self.calls) * self.t["members_per_shard"]

    def reference_taps(self, clips: List[int]) -> Dict[int, List[np.ndarray]]:
        """The plain references' ten taps of each clip, in blocks of 4: the
        non-local SlowFast on the calibrated weights, VGGish as
        ``stages/extract.py`` makes it."""
        dev = self.ctx.device
        sf = W.load_into(W.reference_on_meta(R.SlowFastNlnTaps),
                         {k: v.to(dev) for k, v in self.sf_state.items()}, dev)
        vg = W.load_into(W.reference_on_meta(VggishTaps), W.make_state_dict(
            W.reference_on_meta(VggishTaps), self.ctx.subseed("layer_vggish"), dev), dev)
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        out: Dict[int, List[np.ndarray]] = {}
        try:
            with torch.inference_mode():
                for k in range(0, len(clips), 4):
                    block = clips[k:k + 4]
                    frames = torch.from_numpy(self.frames[block]).to(dev)
                    audio = torch.from_numpy(self.audio[block]).to(dev)
                    valid = torch.full((len(block),), audio.shape[1], device=dev)
                    taps = sf(frames) + vg(audio, valid)
                    for b, clip in enumerate(block):
                        out[clip] = [t[b].double().cpu().numpy() for t in taps]
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
        return out
