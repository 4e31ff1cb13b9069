"""SLOWFAST_NLN_8x8_R50 (``layer_slowfast_nln``) against its plain reference
(``tests/reference_slowfast_nln.py``, PySlowFast's published order in
float32) on the CPU, on seeded random weights: one non-local block of each
instantiation, the core's plain twin (the kernel's order), the whole model's
taps in float32 and bfloat16, the blocks' weight in the taps, PySlowFast's
state-dict names, checkpoint loading, tracing, and stages 4 -> 5 -> 6."""

import pickle

import numpy as np
import pytest
import torch

from acav100m_torch import cli as tcli
from acav100m_torch import tracing
from acav100m_torch.models import get_model
from acav100m_torch.models import slowfast as tsf
from acav100m_torch.models import zoo as tzoo
from acav100m_torch.ops.nonlocal_kernel import nonlocal_core, nonlocal_core_ref
from acav100m_torch.pipeline import feature_extraction as tfe

from . import reference_slowfast_nln as ref_nln

torch.set_num_threads(1)

FRAMES = (2, 16, 64, 64, 3)  # 16 frames at 64^2: Nq 256 / 64, Nk 64 / 16
F32_TOL = 1e-5  # of a tap's largest magnitude


def seeded_state(model: torch.nn.Module, seed: int):
    """Random weights for every key of ``model``: lecun-normal convs, small
    normal biases, BN scales in [0.8, 1.2] ([0.1, 0.3] on a residual
    branch's last norm: each block's ``c_bn`` and each non-local ``bn``),
    shifts and means small normal, variances in [0.8, 1.2]."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, t in model.state_dict().items():
        leaf = name.rsplit(".", 1)[1]
        if t.dtype == torch.long:
            out[name] = torch.zeros_like(t)
        elif leaf == "weight" and t.dim() > 1:
            out[name] = torch.randn(t.shape, generator=gen) / t[0].numel() ** 0.5
        elif leaf == "weight":
            last = name.endswith("c_bn.weight") or "nonlocal" in name and ".bn." in name
            lo, width = (0.1, 0.2) if last else (0.8, 0.4)
            out[name] = lo + width * torch.rand(t.shape, generator=gen)
        elif leaf == "running_var":
            out[name] = 0.8 + 0.4 * torch.rand(t.shape, generator=gen)
        else:
            out[name] = 0.05 * torch.randn(t.shape, generator=gen)
    return out


def frames(seed: int, shape=FRAMES) -> torch.Tensor:
    return torch.randint(0, 256, shape, generator=torch.Generator().manual_seed(seed),
                         dtype=torch.uint8)


@pytest.fixture(scope="module")
def model_and_ref():
    """The reference on seeded weights with its non-local blocks set over
    the clips it is run on (``calibrate_nonlocal``: theta, phi and g centred,
    PySlowFast's precise BN), its taps, and the taps of the same weights with
    the blocks taken out."""
    ref = ref_nln.SlowFastNlnTaps()
    ref.load_state_dict(seeded_state(ref, 7))
    clips = frames(9)
    ref_nln.calibrate_nonlocal(ref, clips)
    state = ref.state_dict()
    without = ref_nln.SlowFastNlnTaps(((), (), (), ()))
    without.load_state_dict({k: v for k, v in state.items() if "nonlocal" not in k})
    with torch.inference_mode():
        return state, clips, ref(clips), without(clips)


def _block_pair(instantiation, dim=64, seed=3):
    ref = ref_nln.Nonlocal(dim, dim // 2, ref_nln.NLN_POOL, instantiation).eval()
    ref.load_state_dict(seeded_state(ref, seed))
    port = tsf.Nonlocal(dim, dim // 2, tsf.NLN_POOL, instantiation).eval()
    port.load_state_dict(ref.state_dict())
    x = torch.relu(torch.randn((2, dim, 4, 8, 8), generator=torch.Generator().manual_seed(seed)))
    return ref, port, x


@pytest.mark.parametrize("instantiation", ["dot_product", "softmax"])
def test_block_matches_reference(instantiation):
    ref, port, x = _block_pair(instantiation)
    with torch.inference_mode():
        want, got = ref(x), port(x)
        got16 = port(x.bfloat16())
    scale = float((want - x).abs().max())
    # float32: the sums in another order (dot_product in the cheaper order)
    assert float((got - want).abs().max()) <= 1e-5 * scale
    # bf16: theta, phi, g, the core's A^T and y, conv_out and the residual
    # each rounded to bf16 (2^-8 relative apiece), against a branch of O(1)
    err16 = float((got16.float() - want).abs().max())
    assert got16.dtype == torch.bfloat16 and err16 <= 4e-2 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_core_twin_matches_published_order(dtype):
    gen = torch.Generator().manual_seed(11)
    theta = torch.randn((3, 32, 96), generator=gen).to(dtype)
    phi = (torch.randn((3, 32, 40), generator=gen) + 0.5).to(dtype)
    g = (torch.randn((3, 32, 40), generator=gen) + 0.3).to(dtype)
    s = torch.einsum("nct,ncp->ntp", theta.float(), phi.float()) / phi.shape[-1]
    want = torch.einsum("ntg,ncg->nct", s, g.float())
    got = nonlocal_core(theta, phi, g)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, nonlocal_core_ref(theta, phi, g))
    err = float((got.float() - want).abs().max() / want.abs().max())
    # float32: sums in another order; bf16: A^T and y rounded (2^-8 each)
    assert err <= (1e-6 if dtype == torch.float32 else 1e-2)


def test_taps_match_reference_float32(model_and_ref):
    state, clips, want, _ = model_and_ref
    for pallas in (True, False):
        model = tsf.LayerSlowFastNln(pallas_stages=pallas)
        model.load_state_dict(state)
        with torch.inference_mode():
            got = model(clips)
        assert [tuple(g.shape) for g in got] == [(2, d) for d in tsf.LAYER_DIMS]
        for g, w in zip(got, want):
            # float32 sums in another order (K2's plain version, the core's
            # cheaper association); measured 1.6e-6 at most
            torch.testing.assert_close(g, w, rtol=0, atol=F32_TOL * float(w.abs().max()))


def test_taps_match_reference_bfloat16(model_and_ref):
    state, clips, want, without = model_and_ref
    model = tsf.LayerSlowFastNln(dtype="bfloat16")
    model.load_state_dict(state)
    with torch.inference_mode():
        got = model(clips)
    for k, (g, w, wo) in enumerate(zip(got, want, without)):
        assert g.dtype == torch.bfloat16
        rms = float((g.float() - w).pow(2).sum().sqrt() / w.pow(2).sum().sqrt())
        # every conv, BN, residual and the non-local cores' A^T and y
        # rounded to bf16 (2^-8 relative apiece), growing through the 16
        # blocks and 5 non-local blocks of s2..s5: measured 1.8e-3 to 3.2e-3
        # up to s3's tap, 7.3e-3 and 1.6e-2 after s4 and s5; each limit is
        # under a third of what taking the blocks out moves the tap
        limit = 1e-2 if k < 3 else 4e-2
        assert rms <= limit, (k, rms)
        if k >= 2:
            moved = float((wo - w).pow(2).sum().sqrt() / w.pow(2).sum().sqrt())
            assert moved >= 3 * limit, (k, moved)


def test_the_blocks_matter(model_and_ref):
    """The same weights with the blocks taken out move the taps after s3 by
    far more than the float32 tolerance."""
    state, clips, want, without = model_and_ref
    model = tsf.LayerSlowFastNln(nonlocal_location=((), (), (), ()))
    model.load_state_dict({k: v for k, v in state.items() if "nonlocal" not in k})
    with torch.inference_mode():
        got = model(clips)
    for k, (g, w, wo) in enumerate(zip(got, want, without)):
        torch.testing.assert_close(g, wo, rtol=0, atol=F32_TOL * float(wo.abs().max()))
        moved = float((g - w).abs().max() / w.abs().max())
        # the taps before s3 hold no block: within float32's rounding
        assert moved <= F32_TOL if k < 2 else moved > 1e3 * F32_TOL, (k, moved)


def test_state_dict_names_are_pyslowfasts():
    model = tsf.LayerSlowFastNln()
    keys = list(model.state_dict())
    nln = [k for k in keys if "nonlocal" in k]
    blocks = ["s3.pathway0_nonlocal1", "s3.pathway0_nonlocal3", "s4.pathway0_nonlocal1",
              "s4.pathway0_nonlocal3", "s4.pathway0_nonlocal5"]
    per_block = [f"{conv}.{p}" for conv in ("conv_theta", "conv_phi", "conv_g", "conv_out")
                 for p in ("weight", "bias")] + [
        f"bn.{p}" for p in ("weight", "bias", "running_mean", "running_var",
                            "num_batches_tracked")]
    assert nln == [f"{b}.{p}" for b in blocks for p in per_block]
    # each block follows its ResBlock, as PySlowFast's ResStage registers it
    assert keys.index("s3.pathway0_nonlocal1.conv_theta.weight") + len(per_block) == \
        keys.index("s3.pathway0_res2.branch2.a.weight")
    assert keys == list(ref_nln.SlowFastNlnTaps().state_dict())
    assert set(keys) - set(nln) == set(tsf.LayerSlowFast().state_dict())
    sd = model.state_dict()
    assert tuple(sd["s3.pathway0_nonlocal1.conv_theta.weight"].shape) == (256, 512, 1, 1, 1)
    assert tuple(sd["s4.pathway0_nonlocal5.conv_out.weight"].shape) == (1024, 512, 1, 1, 1)
    assert get_model("layer_slowfast_nln") is tsf.LayerSlowFastNln
    assert model.output_dims == tsf.LAYER_DIMS
    assert model.model_tag["name"] == "SLOWFAST_NLN_8x8_R50"
    # K2 still runs s2, which has no block; the stages with blocks run canonically
    assert model.s2.fused_slow and not (model.s3.fused_slow or model.s4.fused_slow)


def test_int8_with_nonlocal_blocks_raises():
    with pytest.raises(ValueError, match="non-local"):
        tsf.LayerSlowFastNln(quant="int8")
    tsf.LayerSlowFastNln(quant="int8", nonlocal_location=((), (), (), ()))
    with pytest.raises(ValueError):
        tsf.LayerSlowFastNln(nonlocal_instantiation="gaussian")
    with pytest.raises(ValueError):
        tsf.LayerSlowFastNln(nonlocal_location=((), (4,), (), ()))


def test_seeded_init_zeroes_the_blocks_norm():
    model = tsf.LayerSlowFastNln()
    tsf.zero_init_final_bn(model)
    for name, mod in model.named_modules():
        if isinstance(mod, tsf.Nonlocal):
            assert not mod.bn.weight.any(), name
    clips = frames(4, (1, 8, 32, 32, 3))
    plain = tsf.LayerSlowFast()
    plain.load_state_dict({k: v for k, v in model.state_dict().items() if "nonlocal" not in k})
    with torch.inference_mode():
        for a, b in zip(model(clips), plain(clips)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


def test_flax_tree_round_trip_keeps_the_blocks(model_and_ref):
    state = model_and_ref[0]
    sd = {k: v.numpy() for k, v in state.items()}
    tree = tsf.convert_pyslowfast_state_dict(sd)
    assert set(tree["params"]["s3_slow"]["nonlocal1"]) == {
        "conv_theta", "conv_phi", "conv_g", "conv_out", "bn"}
    back = tsf.state_dict_from_flax(tree)
    assert set(back) == set(state)
    for key, val in back.items():
        assert torch.equal(val, state[key]), key
    # a checkpoint without the blocks converts as before
    plain = tsf.convert_pyslowfast_state_dict({k: v for k, v in sd.items() if "nonlocal" not in k})
    assert "nonlocal1" not in plain["params"]["s3_slow"]


def test_build_models_loads_a_pyslowfast_checkpoint(model_and_ref, tmp_path):
    """A PySlowFast-named SLOWFAST_NLN .pyth of the whole topology through
    ``build_models`` gives the reference's taps."""
    state, clips, want, _ = model_and_ref
    path = tmp_path / "slowfast_nln.pyth"
    torch.save({"model_state": {**state, "head.projection.weight": torch.zeros(400, 2304)},
                "epoch": 196}, path)
    cfg = tfe.get_config({"models": ["layer_slowfast_nln"], "computation.device": "cpu",
                          "weights.slowfast_file": str(path)})
    model = tfe.build_models(cfg)["layer_slowfast_nln"]
    assert isinstance(model, tsf.LayerSlowFastNln)
    with torch.inference_mode():
        got = model(clips)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=F32_TOL * float(w.abs().max()))
    # the caffe2 name map knows no non-local blob: it raises on them
    blobs = {tzoo.pyslowfast_to_caffe2_name(k): v.numpy() for k, v in state.items()
             if "nonlocal" not in k and not k.endswith("num_batches_tracked")}
    blobs["nonlocal_conv3_1_theta_w"] = np.zeros((256, 512, 1, 1, 1), np.float32)
    with pytest.raises(ValueError, match="nonlocal_conv3_1_theta_w"):
        tzoo.caffe2_to_pyslowfast(blobs)


def test_blocks_counted_and_spanned(model_and_ref):
    clips = model_and_ref[1]
    model = tsf.LayerSlowFastNln()
    model.load_state_dict(model_and_ref[0])
    with tracing.enabled():
        with torch.inference_mode():
            model(clips)
            model(clips)
    assert tracing.counters()["nonlocal.blocks"] == 10
    assert "nln_bf16.launches" not in tracing.counters()  # CPU: the plain twin
    spans = [s for s in tracing.spans() if s.name == "span.extract.nonlocal"]
    assert len(spans) == 10 and all(s.end_ns >= s.start_ns for s in spans)


def test_stages_4_5_6_end_to_end(tmp_path):
    cpu = "computation.device=cpu"
    spec = "shard-{000000..000001}"
    # frames of 32^2: res4 is 2 x 2, which the blocks' 1x2x2 pool halves
    tcli.main(["fixtures", str(tmp_path / "clips"), "--size=32"])
    tcli.main(["extract", f"data.media.path={tmp_path}/clips/{spec}.tar",
               f"data.output.path={tmp_path}/features", "data.batch_size=4",
               "data.media.num_frames=8", cpu, "computation.dtype=bfloat16",
               'models=["layer_vggish", "layer_slowfast_nln"]'])
    rows = pickle.loads((tmp_path / "features" / "shard-000000.pkl").read_bytes())
    feats = rows[0]["video_features"]
    assert [f["model_key"] for f in feats] == ["layer_slowfast_nln"]
    assert feats[0]["extractor_name"] == "SLOWFAST_NLN_8x8_R50"
    assert [np.asarray(feats[0]["array"][f"layer_{i}"]).shape for i in range(5)] == \
        [(d,) for d in tsf.LAYER_DIMS]
    tcli.main(["cluster", f"data.path={tmp_path}/features/{spec}.pkl",
               f"data.output.path={tmp_path}/clusters", "data.batch_size=4",
               "clustering.ncentroids=4", cpu])
    tcli.main(["select", f"data.path={tmp_path}/clusters/{spec}.pkl",
               f"data.output.path={tmp_path}/output.csv", f"data.meta.path={tmp_path}/clips",
               "subset.ratio=0.875", "batch.batch_size=6", "batch.selection_size=4", cpu])
    out = (tmp_path / "output.csv").read_text().splitlines()
    assert len(out) == 7  # round(0.875 * 8)
