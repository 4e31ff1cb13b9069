"""The port's sharded pretrain step on the CPU: two gloo ranks against the
JAX package's ``make_pretrain_step(mesh=get_mesh(num_devices=2))``.

One spawn of two rank processes (``tests/torch_eval_dist_workers.py``,
which imports only the port) runs every scenario on inputs written here
and writes its results; the spawn has a limit of its own and is killed
past it. While the ranks run, this process takes the JAX package's mesh
step and the port's unsharded step on the same global batch. The main
comparison is ``tests/test_torch_evaluation_full.py``'s: the full-width
``Contrast`` in float64 from the seed-3 weight tree, one adamw step at a
global batch of 4 (2 a rank), 4 frames of 32^2 of 0 or 255, at that
file's tolerances (loss 1e-5, every parameter 1e-4 relative L2, running
statistics 1e-6 of their max, accuracy equal). The sharded step against
the port's unsharded step on the same 4 rows: 1e-9 (the JAX package's own
pair agrees to 4.4e-11), and the two ranks bit-identical. The collectives
alone (the gather's gradient, batch norm over the group) against one
process on all rows in float64: 1e-12 of their max; through a narrow
backbone, plain and rematerialized, and the gradients a narrow
``Contrast``'s step leaves: 1e-10."""

import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from acav100m_tpu.evaluation import models as jm
from acav100m_tpu.evaluation import train as jt
from acav100m_tpu.runtime import get_mesh
from acav100m_torch import runtime
from acav100m_torch.evaluation import models as tm
from acav100m_torch.evaluation import train as tt

from .torch_eval_dist_workers import BN_CASES
from .torch_parity import random_variables

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
WORLD = 2
SPAWN_LIMIT_S = 420
B, T, CROP = 4, 4, 32
LOSS_TOL = 1e-5  # absolute, against the JAX package
PARAM_RTOL = 1e-4  # relative L2 of each updated parameter, against the JAX package
STATS_RTOL = 1e-6  # running statistics, relative to their largest magnitude
SHARDED_RTOL = 1e-9  # the sharded step against the port's unsharded step
COLLECTIVE_TOL = 1e-12  # one collective against one process, float64
NARROW_TOL = 1e-10  # a narrow backbone over the group against one process


def f64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _jax_mesh_step(var, visual, audio):
    with jax.enable_x64(True):
        model = jm.Contrast(train=True, dtype=jnp.float64)
        opt = jt.build_optimizer("adamw", jt.lr_schedule("linear", 1e-3, 10, warmup_steps=0))
        state = jt.TrainState(var["params"], var["batch_stats"], opt.init(var["params"]),
                              jnp.zeros((), jnp.int32))
        step = jt.make_pretrain_step(model, opt, mesh=get_mesh(num_devices=WORLD))
        new, metrics = step(state, jnp.asarray(visual), jnp.asarray(audio))
        return (f64(new.params), f64(new.batch_stats), float(metrics["loss"]),
                float(metrics["acc"]))


def _port_step(tree_path: Path, visual, audio):
    state = tt.init_pretrain(0, tt.lr_schedule("linear", 1e-3, 10, warmup_steps=0), "cpu")
    state.model.load_state_dict(torch.load(tree_path))
    state.model.double()
    state.optimizer = tt.build_optimizer("adamw", state.model.named_parameters(),
                                         state.schedule)
    state, metrics = tt.make_pretrain_step(state)(state, visual, audio)
    return state.model.state_dict(), float(metrics["loss"]), float(metrics["acc"])


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """Inputs, then one 2-rank gloo spawn over all scenarios while this
    process runs the JAX mesh step and the port's unsharded step; returns
    the inputs, both steps and each rank's results."""
    work = tmp_path_factory.mktemp("eval_dist")
    rng = np.random.RandomState(0)
    visual = (rng.randint(0, 2, (B, T, CROP, CROP, 3)) * 255).astype(np.uint8)
    audio = rng.randn(B, 80, 128, 1)
    np.savez(work / "batch.npz", visual=visual, audio=audio)
    np.savez(work / "pretrain.npz",
             visual=rng.randint(0, 256, (3, 2, T, CROP, CROP, 3)).astype(np.uint8),
             audio=rng.randn(3, 2, 80, 128, 1).astype(np.float32))
    with jax.enable_x64(True):
        shapes = jax.eval_shape(lambda: jm.Contrast(train=True, dtype=jnp.float64).init(
            jax.random.PRNGKey(0), jnp.zeros(visual.shape), jnp.asarray(audio)))
    var = f64(random_variables(shapes, seed=3))
    torch.save(tm.state_dict_from_flax(var), work / "tree.pt")
    address = f"tcp://127.0.0.1:{_free_port()}"
    logs = [work / f"rank{rank}.log" for rank in range(WORLD)]
    procs = []
    for rank, log in enumerate(logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "tests.torch_eval_dist_workers", str(rank), str(WORLD),
                 address, str(work)], cwd=REPO, stdout=out, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + SPAWN_LIMIT_S
    try:
        jax_step = _jax_mesh_step(var, visual, audio)
        port_step = _port_step(work / "tree.pt", visual, audio)
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the 2-rank spawn ran past {SPAWN_LIMIT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for ckpt in (work / "run").glob("*.ckpt"):
            ckpt.unlink()  # 0.7 GB each at full width with AdamW's moments
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log.read_text()[-3000:]
    results = []
    for rank in range(WORLD):
        arrays = dict(np.load(work / f"rank{rank}.npz"))
        arrays.update(json.loads((work / f"rank{rank}.json").read_text()))
        results.append(arrays)
    sharded = torch.load(work / "rank0_state.pt")
    (work / "rank0_state.pt").unlink()
    return {"work": work, "var": var, "jax": jax_step, "port": port_step,
            "sharded": sharded, "ranks": results}


def test_sharded_step_matches_jax_mesh_step(sharded_run):
    var = sharded_run["var"]
    want_params, want_stats, want_loss, want_acc = sharded_run["jax"]
    r0 = sharded_run["ranks"][0]
    assert r0["step_step"] == 1
    assert abs(r0["step_loss"] - want_loss) <= LOSS_TOL
    assert r0["step_acc"] == want_acc
    tree = tm.flax_from_state_dict(sharded_run["sharded"])
    moved = 0
    for w, g, p0 in zip(jax.tree.leaves(want_params), jax.tree.leaves(tree["params"]),
                        jax.tree.leaves(var["params"])):
        assert np.linalg.norm(w - g) <= PARAM_RTOL * np.linalg.norm(w)
        moved += int(not np.array_equal(g, p0))
    assert moved == len(jax.tree.leaves(var["params"]))  # lr > 0: every param moved
    for w, g in zip(jax.tree.leaves(want_stats), jax.tree.leaves(tree["batch_stats"])):
        assert np.abs(w - g).max() <= STATS_RTOL * np.abs(w).max()


def test_two_ranks_end_bit_identical(sharded_run):
    r0, r1 = sharded_run["ranks"]
    for key in ("step_loss", "step_acc", "step_step", "step_params", "step_stats",
                "step_opt"):
        assert r0[key] == r1[key], key


def test_sharded_step_matches_the_unsharded_step(sharded_run):
    """Two ranks of 2 rows against one process on the 4 rows: the global
    loss and the gradient scaling (each rank's share over the global 2B,
    the gradients summed over the ranks) give the unsharded step."""
    want, want_loss, want_acc = sharded_run["port"]
    got = sharded_run["sharded"]
    r0 = sharded_run["ranks"][0]
    assert abs(r0["step_loss"] - want_loss) <= SHARDED_RTOL * abs(want_loss)
    assert r0["step_acc"] == want_acc
    assert set(got) == set(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == int(w) == 1, k
        elif k.endswith(("running_mean", "running_var")):
            assert (got[k] - w).abs().max() <= SHARDED_RTOL * w.abs().max(), k
        else:
            assert (got[k] - w).norm() <= SHARDED_RTOL * w.norm(), k


def test_step_gradients_are_the_global_loss_gradients(sharded_run):
    """Adam's first step is nearly blind to the gradients' scale, so the
    scaling is pinned on the gradients themselves: a narrow ``Contrast``'s
    step over the group leaves (summed over the ranks) the gradients of one
    process's step on all rows, not twice or half of them."""
    for r in sharded_run["ranks"]:
        assert r["grads_err"] <= NARROW_TOL
        assert abs(r["grads_ratio"] - 1.0) <= NARROW_TOL
        assert abs(r["grads_loss_sharded"] - r["grads_loss_one"]) <= NARROW_TOL


def test_gathered_rows_gradient_matches_concatenation(sharded_run):
    for r in sharded_run["ranks"]:
        want = r["gather_want"]
        assert np.abs(r["gather_grad"] - want).max() <= COLLECTIVE_TOL * np.abs(want).max()


@pytest.mark.parametrize("ndim", sorted(BN_CASES))
def test_group_batch_norm_matches_batch_norm_on_all_rows(sharded_run, ndim):
    """Forward, the input's, weight's and bias's gradients (the latter
    summed over the ranks) and the running statistics."""
    for r in sharded_run["ranks"]:
        for name in ("y", "dx", "dw", "db", "mean", "var"):
            got, want = r[f"bn{ndim}_{name}"], r[f"bn{ndim}_{name}_want"]
            assert np.abs(got - want).max() <= COLLECTIVE_TOL * np.abs(want).max(), name


@pytest.mark.parametrize("tag", ["plain", "remat"])
def test_backbone_over_the_group_matches_one_process(sharded_run, tag):
    """A narrow visual backbone over the group, with and without
    rematerialized blocks (whose recompute issues the collectives again and
    updates the statistics once), against one process on all rows."""
    for r in sharded_run["ranks"]:
        for what in ("y", "grad", "stats"):
            assert r[f"narrow_{tag}_{what}"] <= NARROW_TOL, what
        assert r[f"narrow_{tag}_tracked"] == [1]


def test_uneven_batch_raises_on_every_rank(sharded_run):
    for r in sharded_run["ranks"]:
        assert "3 rows does not split evenly over 2 ranks" in r["uneven"]
        assert "init_pretrain(group=)" in r["mismatch"]


def test_pretrain_over_the_group_writes_on_rank_0_and_resumes(sharded_run):
    r0, r1 = sharded_run["ranks"]
    for r in (r0, r1):
        assert r["pretrain_runs"] == [[3, [1, 2, 3]], [4, [4]]]
    assert r0["pretrain_saves"] == ["step_latest", "epoch_latest", "epoch_latest"]
    assert r1["pretrain_saves"] == []
    assert r0["pretrain_state"] == r1["pretrain_state"]
    lines = [json.loads(x) for x in
             (sharded_run["work"] / "run" / "stats.jsonl").read_text().splitlines()]
    assert [(x["_type"], x["step"]) for x in lines] == [
        ("train_iter", 1), ("train_iter", 2), ("train_iter", 3), ("train_done", 3),
        ("train_iter", 4), ("train_done", 4)]


def test_shard_rows_cuts_the_rank_block():
    x = np.arange(12).reshape(6, 2)
    for rank in range(3):
        group = runtime.Group(rank, 3, torch.device("cpu"), "gloo")
        np.testing.assert_array_equal(runtime.shard_rows(x, group), x[2 * rank:2 * rank + 2])
        assert torch.equal(runtime.shard_rows(torch.from_numpy(x), group),
                           torch.from_numpy(x[2 * rank:2 * rank + 2]))
    assert runtime.shard_rows(x, None) is x
    with pytest.raises(ValueError, match="7 rows"):
        runtime.shard_rows(np.zeros((7, 2)), runtime.Group(0, 2, torch.device("cpu"), "gloo"))


def test_one_process_group_is_the_unsharded_path():
    """A group without a process group (one process) runs the local batch
    norm and loss, and the collectives are the identity."""
    group = runtime.Group(0, 1, torch.device("cpu"))
    t = torch.randn(3, 4, requires_grad=True)
    assert runtime.all_gather_rows(t, group) is t and runtime.sum_shares(t, group) is t
    runtime.all_reduce_sum_flat([t], group)
    runtime.broadcast_flat([t], group)
    zv, za = (torch.nn.functional.normalize(torch.randn(4, 8), dim=-1) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(tm.contrast_loss(zv, za, group=group),
                                                 tm.contrast_loss(zv, za)))
