"""One rank of the port's sharded pretrain tests (``test_torch_evaluation_sharded``).

    python -m tests.torch_eval_dist_workers RANK WORLD ADDRESS WORKDIR

Imports only the port (no JAX, no test module), joins a gloo group at
ADDRESS, runs every scenario on the inputs the test wrote into WORKDIR and
writes ``rank{RANK}.npz`` and ``rank{RANK}.json`` there (and rank 0's
state dict after the full-width step, ``rank0_state.pt``):

* ``gather``: ``all_gather_rows``'s gradient against autograd through a
  plain concatenation of the global rows, float64;
* ``bn``: ``BatchNorm`` over the group against ``nn.BatchNorm{1,2,3}d`` on
  the concatenated rows, and a narrow ``VisualResNet3D`` over the group,
  plain and rematerialized, against one process's on all rows, float64;
* ``uneven``: a global batch of 3 rows on 2 ranks, which must raise;
* ``grads``: the gradients of a narrow ``Contrast``'s step over the group
  against one process's step on all rows, float64;
* ``step``: one full-width float64 step of the seeded tree on the test's
  global batch of 4;
* ``pretrain``: ``pretrain(group=)`` for 3 steps with an ``out_dir``, then
  resumed to 4.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch import nn

from acav100m_torch import runtime
from acav100m_torch.evaluation import models as tm
from acav100m_torch.evaluation import train as tt

BN_CASES = {2: (12, 6), 4: (4, 5, 3, 7), 5: (4, 3, 2, 5, 3)}  # global input shapes
NARROW = (4, 3, 4, 32, 32)  # the narrow visual backbone's global input


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def rows(x: torch.Tensor, group) -> torch.Tensor:
    per = x.shape[0] // group.world_size
    return x[group.rank * per:(group.rank + 1) * per]


def run_gather(group, work: Path, out: dict) -> None:
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, generator=gen, dtype=torch.float64)
    w = torch.randn(group.world_size, 6, 5, generator=gen, dtype=torch.float64)
    # each rank's share: a nonlinear function of its rows and of all rows
    mine = rows(x, group).clone().requires_grad_(True)
    g = runtime.all_gather_rows(mine, group)
    share = ((g * w[group.rank]).sum(1).tanh() * (mine.square().sum() + 1)).sum()
    share.backward()
    ref = x.clone().requires_grad_(True)
    total = sum(((ref * w[r]).sum(1).tanh() * (rows(ref, group_at(group, r)).square().sum()
                                               + 1)).sum() for r in range(group.world_size))
    total.backward()
    out["gather_grad"] = mine.grad.numpy()
    out["gather_want"] = rows(ref.grad, group).numpy()


def group_at(group, rank: int):
    return runtime.Group(rank, group.world_size, group.device, group.backend)


def run_bn(group, work: Path, out: dict) -> None:
    gen = torch.Generator().manual_seed(1)
    for ndim, shape in BN_CASES.items():
        x = torch.randn(shape, generator=gen, dtype=torch.float64) * 3 + 1
        r = torch.randn(shape, generator=gen, dtype=torch.float64)
        c = shape[1]
        ours = tm.BatchNorm(c, ndim).double().train()
        ref = {2: nn.BatchNorm1d, 4: nn.BatchNorm2d, 5: nn.BatchNorm3d}[ndim](
            c, eps=tm.BN_EPS, momentum=tm.BN_MOMENTUM).double().train()
        with torch.no_grad():
            for m in (ours, ref):
                m.weight.copy_(torch.linspace(0.5, 1.5, c))
                m.bias.copy_(torch.linspace(-0.2, 0.3, c))
        tm.set_group(ours, group)
        xl = rows(x, group).clone().requires_grad_(True)
        y = ours(xl)
        (y * rows(r, group)).sum().backward()
        runtime.all_reduce_sum_flat([ours.weight.grad, ours.bias.grad], group)
        xr = x.clone().requires_grad_(True)
        yr = ref(xr)
        (yr * r).sum().backward()
        for name, got, want in (("y", y, rows(yr, group)), ("dx", xl.grad, rows(xr.grad, group)),
                                ("dw", ours.weight.grad, ref.weight.grad),
                                ("db", ours.bias.grad, ref.bias.grad),
                                ("mean", ours.running_mean, ref.running_mean),
                                ("var", ours.running_var, ref.running_var)):
            out[f"bn{ndim}_{name}"] = got.detach().numpy()
            out[f"bn{ndim}_{name}_want"] = want.detach().numpy()
    x = torch.randn(NARROW, generator=gen, dtype=torch.float64)
    r = torch.randn(NARROW[0], 256, generator=gen, dtype=torch.float64)
    for remat in (False, True):
        nets = []
        for sharded in (True, False):
            net = tm.VisualResNet3D(width=8, remat=remat and sharded)
            tm.init_eval_weights(net, torch.Generator().manual_seed(2))
            bn_gen = torch.Generator().manual_seed(3)
            with torch.no_grad():
                for name, p in net.named_parameters():  # non-zero BN gammas
                    if name.endswith("bn.weight"):
                        p.uniform_(0.5, 1.5, generator=bn_gen)
            net.double().train()
            tm.set_group(net, group if sharded else None)
            inp = (rows(x, group) if sharded else x).clone().requires_grad_(True)
            y = net(inp)
            (y * (rows(r, group) if sharded else r)).sum().backward()
            if sharded:
                runtime.all_reduce_sum_flat([p.grad for p in net.parameters()], group)
            nets.append((net, y if sharded else rows(y, group)))
        tag = "remat" if remat else "plain"
        (ours, y), (ref, yr) = nets
        out[f"narrow_{tag}_y"] = (y - yr).abs().max().item() / yr.abs().max().item()
        out[f"narrow_{tag}_grad"] = max((p.grad - q.grad).norm().item() / q.grad.norm().item()
                                        for p, q in zip(ours.parameters(), ref.parameters()))
        out[f"narrow_{tag}_stats"] = max((a.double() - b.double()).abs().max().item()
                                         / max(b.double().abs().max().item(), 1e-30)
                                         for a, b in zip(ours.buffers(), ref.buffers()))
        out[f"narrow_{tag}_tracked"] = sorted({int(m.num_batches_tracked)
                                               for m in ours.modules()
                                               if isinstance(m, tm.BatchNorm)})


def narrow_state(group):
    model = tm.Contrast(visual_width=8, audio_width=4)
    tm.init_eval_weights(model, torch.Generator().manual_seed(0))
    tm.set_group(model, group)
    schedule = tt.lr_schedule("linear", 1e-3, 10)
    return tt.TrainState(model.train(), tt.build_optimizer(
        "adamw", model.named_parameters(), schedule), schedule)


def run_uneven(group, work: Path, out: dict) -> None:
    state = narrow_state(group)
    inp = np.load(work / "batch.npz")
    try:
        tt.make_pretrain_step(state, group)(state, inp["visual"][:3], inp["audio"][:3])
        out["uneven"] = "no error"
    except ValueError as err:
        out["uneven"] = str(err)
    try:
        tt.make_pretrain_step(state)
        out["mismatch"] = "no error"
    except ValueError as err:
        out["mismatch"] = str(err)


def run_grads(group, work: Path, out: dict) -> None:
    """The gradients a narrow ``Contrast``'s step leaves (summed over the
    ranks) against one process's step on all rows: the loss's scaling."""
    inp = np.load(work / "batch.npz")
    grads = []
    for g in (group, None):
        state = narrow_state(g)
        state.model.double()
        state, metrics = tt.make_pretrain_step(state, g)(state, inp["visual"], inp["audio"])
        grads.append([p.grad for p in state.model.parameters()])
        out[f"grads_loss_{'sharded' if g else 'one'}"] = float(metrics["loss"])
    out["grads_err"] = max(((a - b).norm() / b.norm()).item() for a, b in zip(*grads))
    out["grads_ratio"] = (torch.cat([a.reshape(-1) for a in grads[0]]).norm()
                          / torch.cat([b.reshape(-1) for b in grads[1]]).norm()).item()


def run_step(group, work: Path, out: dict) -> None:
    inp = np.load(work / "batch.npz")
    state = tt.init_pretrain(0, tt.lr_schedule("linear", 1e-3, 10, warmup_steps=0), "cpu",
                             group=group)
    state.model.load_state_dict(torch.load(work / "tree.pt"))
    state.model.double()
    state.optimizer = tt.build_optimizer("adamw", state.model.named_parameters(),
                                         state.schedule)
    state, metrics = tt.make_pretrain_step(state, group)(state, inp["visual"], inp["audio"])
    out["step_loss"] = float(metrics["loss"])
    out["step_acc"] = float(metrics["acc"])
    out["step_step"] = state.step
    sd = state.model.state_dict()
    out["step_params"] = digest(p for _, p in state.model.named_parameters())
    out["step_stats"] = digest(b for _, b in state.model.named_buffers())
    opt = state.optimizer.state_dict()["state"]
    out["step_opt"] = digest(v for i in sorted(opt) for _, v in sorted(opt[i].items()))
    if group.rank == 0:
        torch.save(sd, work / "rank0_state.pt")


def run_pretrain(group, work: Path, out: dict) -> None:
    inp = np.load(work / "pretrain.npz")
    batches = [{"visual": v, "audio": a} for v, a in zip(inp["visual"], inp["audio"])]
    saves = []
    real = tt.save_checkpoint

    def counted(out_dir, state, epoch, name="epoch_latest", backend="pickle"):
        saves.append(name)
        return real(out_dir, state, epoch, name, backend)

    tt.save_checkpoint = counted
    try:
        runs = []
        for num_steps in (3, 4):
            state, history = tt.pretrain(iter(batches), num_steps, out_dir=work / "run",
                                         save_period=3, warmup_steps=0, log_every=1,
                                         device="cpu", group=group)
            runs.append((state.step, [h["step"] for h in history]))
    finally:
        tt.save_checkpoint = real
    out["pretrain_runs"] = runs
    out["pretrain_saves"] = saves
    out["pretrain_state"] = digest(state.model.state_dict().values())


def main(argv) -> None:
    rank, world, address, work = int(argv[0]), int(argv[1]), argv[2], Path(argv[3])
    torch.set_num_threads(1)
    group = runtime.initialize_runtime(address, world, rank, device="cpu", timeout_s=300)
    arrays, meta = {}, {}
    try:
        for scenario in (run_gather, run_bn, run_uneven, run_grads, run_step, run_pretrain):
            out: dict = {}
            scenario(group, work, out)
            for key, val in out.items():
                (arrays if isinstance(val, np.ndarray) else meta)[key] = val
    finally:
        runtime.shutdown_runtime(group)
    np.savez(work / f"rank{rank}.npz", **arrays)
    (work / f"rank{rank}.json").write_text(json.dumps(meta))


if __name__ == "__main__":
    main(sys.argv[1:])
