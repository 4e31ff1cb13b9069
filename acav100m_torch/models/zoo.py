"""Checkpoint loading and conversion: the flax ``.npz`` format and the
published torch/caffe2 checkpoints.

A copy of the conversion half of ``acav100m_tpu/models/zoo.py`` (the port
imports nothing of the JAX package); the model-zoo table parsing and the
download helpers are left out. Every checkpoint reaches the port's models
the same way: checkpoint -> the JAX package's flax tree
(``slowfast.convert_pyslowfast_state_dict``,
``vggish.convert_torch_state_dict``) -> ``state_dict_from_flax``. So the
``convert`` verb's ``.npz`` and a checkpoint loaded directly give the same
numbers, and the keys the taps do not use (heads, optimizer state) are left
behind.
"""

from __future__ import annotations

import hashlib
import json
import pickle
import re
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

# -- flax npz round trip --------------------------------------------------------


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts -> {'/'-joined key: array}."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_flax_npz(tree: Dict, path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flatten_tree(tree))
    return path


def load_flax_npz(path) -> Dict:
    """A converted flax tree saved as ``.npz`` -> nested numpy dicts."""
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def sha256_file(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# -- torch / caffe2 checkpoint loading -----------------------------------------

def load_torch_checkpoint(path) -> Dict[str, np.ndarray]:
    """Torch ``.pt/.pth/.pyth`` or pickle ``.pkl`` checkpoint -> flat
    {name: np.ndarray}.

    Handles PySlowFast save files (``{'model_state': ...}``), plain
    ``state_dict``s, torch.hub VGGish (flat) and caffe2 pickles
    (``{'blobs': ...}``, latin1-encoded numpy). A checkpoint is trusted
    input: unpickling it can run code, as ``torch.load`` with
    ``weights_only=False`` can, which PySlowFast's containers need.
    """
    path = Path(path)
    if path.suffix == ".pkl":
        with open(path, "rb") as f:
            obj = pickle.load(f, encoding="latin1")
    else:
        import torch

        obj = torch.load(path, map_location="cpu", weights_only=False)
    for container in ("blobs", "model_state", "state_dict", "model"):
        if isinstance(obj, dict) and container in obj and isinstance(obj[container], dict):
            obj = obj[container]
            break
    out = {}
    for k, v in obj.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            out[str(k)] = v
    return out


# caffe2 blob name -> PySlowFast module name, the rules of PySlowFast's own
# converter (slowfast/utils/checkpoint.py): stems `conv1`/`res_conv1_bn`,
# blocks `res{n}_{j}_branch{1,2a,2b,2c}`, fuse convs `t_pool1_subsample`
# (after s1) and `t_res{n}_{j}_branch2c_bn_subsample` (after s2..s4), a
# `_fast` infix on fast-pathway blobs, BN statistics with the caffe2
# suffixes s/b/rm/riv. Unknown blobs raise.
_BN_SUFFIX = {"s": "weight", "b": "bias", "rm": "running_mean", "riv": "running_var"}


def is_caffe2(sd: Dict) -> bool:
    """Whether a SlowFast checkpoint carries caffe2 blob names."""
    return any("branch2a" in k or k == "conv1_w" for k in sd)


def caffe2_to_pyslowfast(blobs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Translate caffe2 blob names to PySlowFast state-dict names; momentum
    blobs and the classification head are skipped. Raises ``ValueError``
    listing the blobs it cannot map."""
    out: Dict[str, np.ndarray] = {}
    unmapped: List[str] = []
    for name, value in blobs.items():
        if name.endswith("_momentum") or name.startswith(("pred_", "fc_", "last_")):
            continue  # optimizer state / classification head: unused by taps
        pathway = 1 if "_fast" in name else 0
        key = name.replace("_fast", "")
        new = _translate_one(key, pathway)
        if new is None:
            unmapped.append(name)
        else:
            out[new] = np.asarray(value)
    if unmapped:
        raise ValueError(
            f"unmapped caffe2 blobs: {sorted(unmapped)[:20]}"
            + ("..." if len(unmapped) > 20 else "")
        )
    return out


def _translate_one(key: str, pathway: int) -> Optional[str]:
    pw = f"pathway{pathway}"
    # fuse after s1: t_pool1_subsample{_bn}_{suffix}
    m = re.fullmatch(r"t_pool1_subsample_bn_(s|b|rm|riv)", key)
    if m:
        return f"s1_fuse.bn.{_BN_SUFFIX[m.group(1)]}"
    if key == "t_pool1_subsample_w":
        return "s1_fuse.conv_f2s.weight"
    # fuse after s2..s4: t_res{n}_{j}_branch2c_bn_subsample
    m = re.fullmatch(r"t_res([0-9]+)_[0-9]+_branch2c_bn_subsample_bn_(s|b|rm|riv)", key)
    if m:
        return f"s{m.group(1)}_fuse.bn.{_BN_SUFFIX[m.group(2)]}"
    m = re.fullmatch(r"t_res([0-9]+)_[0-9]+_branch2c_bn_subsample_w", key)
    if m:
        return f"s{m.group(1)}_fuse.conv_f2s.weight"
    # stem: conv1_w / res_conv1_bn_*
    if key == "conv1_w":
        return f"s1.{pw}_stem.conv.weight"
    m = re.fullmatch(r"res_conv1_bn_(s|b|rm|riv)", key)
    if m:
        return f"s1.{pw}_stem.bn.{_BN_SUFFIX[m.group(1)]}"
    # blocks: res{n}_{j}_branch1_w, res{n}_{j}_branch2{a,b,c}_w, and their BNs
    m = re.fullmatch(r"res([0-9]+)_([0-9]+)_branch1_w", key)
    if m:
        return f"s{m.group(1)}.{pw}_res{m.group(2)}.branch1.weight"
    m = re.fullmatch(r"res([0-9]+)_([0-9]+)_branch1_bn_(s|b|rm|riv)", key)
    if m:
        return f"s{m.group(1)}.{pw}_res{m.group(2)}.branch1_bn.{_BN_SUFFIX[m.group(3)]}"
    m = re.fullmatch(r"res([0-9]+)_([0-9]+)_branch2([abc])_w", key)
    if m:
        return f"s{m.group(1)}.{pw}_res{m.group(2)}.branch2.{m.group(3)}.weight"
    m = re.fullmatch(r"res([0-9]+)_([0-9]+)_branch2([abc])_bn_(s|b|rm|riv)", key)
    if m:
        return (
            f"s{m.group(1)}.{pw}_res{m.group(2)}.branch2."
            f"{m.group(3)}_bn.{_BN_SUFFIX[m.group(4)]}"
        )
    return None


def pyslowfast_to_caffe2_name(name: str) -> Optional[str]:
    """Inverse of :func:`_translate_one`: writes caffe2-named checkpoints
    (the published SLOWFAST_8x8_R50 form) from PySlowFast names."""
    inv_bn = {v: k for k, v in _BN_SUFFIX.items()}

    m = re.fullmatch(r"s1_fuse\.bn\.(\w+)", name)
    if m:
        return f"t_pool1_subsample_bn_{inv_bn[m.group(1)]}"
    if name == "s1_fuse.conv_f2s.weight":
        return "t_pool1_subsample_w"
    m = re.fullmatch(r"s([0-9]+)_fuse\.bn\.(\w+)", name)
    if m:
        return f"t_res{m.group(1)}_0_branch2c_bn_subsample_bn_{inv_bn[m.group(2)]}"
    m = re.fullmatch(r"s([0-9]+)_fuse\.conv_f2s\.weight", name)
    if m:
        return f"t_res{m.group(1)}_0_branch2c_bn_subsample_w"
    m = re.fullmatch(r"s1\.pathway([01])_stem\.conv\.weight", name)
    if m:
        return _fastify("conv1_w", m.group(1))
    m = re.fullmatch(r"s1\.pathway([01])_stem\.bn\.(\w+)", name)
    if m:
        return _fastify(f"res_conv1_bn_{inv_bn[m.group(2)]}", m.group(1))
    m = re.fullmatch(r"s([0-9]+)\.pathway([01])_res([0-9]+)\.branch1\.weight", name)
    if m:
        return _fastify(f"res{m.group(1)}_{m.group(3)}_branch1_w", m.group(2))
    m = re.fullmatch(r"s([0-9]+)\.pathway([01])_res([0-9]+)\.branch1_bn\.(\w+)", name)
    if m:
        return _fastify(
            f"res{m.group(1)}_{m.group(3)}_branch1_bn_{inv_bn[m.group(4)]}", m.group(2))
    m = re.fullmatch(r"s([0-9]+)\.pathway([01])_res([0-9]+)\.branch2\.([abc])\.weight", name)
    if m:
        return _fastify(f"res{m.group(1)}_{m.group(3)}_branch2{m.group(4)}_w", m.group(2))
    m = re.fullmatch(
        r"s([0-9]+)\.pathway([01])_res([0-9]+)\.branch2\.([abc])_bn\.(\w+)", name)
    if m:
        return _fastify(
            f"res{m.group(1)}_{m.group(3)}_branch2{m.group(4)}_bn_{inv_bn[m.group(5)]}",
            m.group(2))
    return None


def _fastify(base: str, pathway: str) -> str:
    if pathway == "0":
        return base
    # the `_fast` infix sits before the parameter-kind suffix
    for sfx in ("_w", "_bn_s", "_bn_b", "_bn_rm", "_bn_riv"):
        if base.endswith(sfx):
            return base[: -len(sfx)] + "_fast" + sfx
    return base + "_fast"


# -- convert verb ---------------------------------------------------------------

def convert_checkpoint(model: str, in_path, out_path, fmt: Optional[str] = None) -> Dict:
    """torch/caffe2 checkpoint -> flax ``.npz`` + a ``.json`` manifest with
    sha256 sums, the JAX package's ``convert``.

    model: 'slowfast' | 'vggish'. fmt: 'pyslowfast' (torch module names,
    the default for slowfast), 'caffe2' (blob names, detected by name), or
    'vggish'.
    """
    from . import slowfast, vggish

    in_path, out_path = Path(in_path), Path(out_path)
    sd = load_torch_checkpoint(in_path)
    if model == "slowfast":
        if fmt is None:
            fmt = "caffe2" if is_caffe2(sd) else "pyslowfast"
        if fmt == "caffe2":
            sd = caffe2_to_pyslowfast(sd)
        tree = slowfast.convert_pyslowfast_state_dict(sd)
    elif model == "vggish":
        tree = vggish.convert_torch_state_dict(sd)
    else:
        raise ValueError(f"unknown model {model!r} (slowfast|vggish)")
    save_flax_npz(tree, out_path)
    manifest = {
        "model": model,
        "format": fmt or model,
        "input": str(in_path),
        "input_sha256": sha256_file(in_path),
        "output": str(out_path),
        "output_sha256": sha256_file(out_path),
        "num_params": len(flatten_tree(tree)),
    }
    Path(str(out_path) + ".json").write_text(json.dumps(manifest, indent=1))
    return manifest
