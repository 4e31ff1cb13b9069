"""Faults planted under a run's timed path, to show that the check catches
them (``tests/test_portbench_faults.py`` on the CPU, ``control.py`` on the
card). Each is a ``stage_hook``: it takes the set-up stage and breaks the
program underneath it for the window.
"""

from __future__ import annotations

import torch


def _wrap_forward(model, fn):
    orig = model.forward

    def forward(*args, **kwargs):
        return fn(orig(*args, **kwargs))

    model.forward = forward


def extract_altered_answer(stage):
    """One tap of every row scaled by 1.01 where the model produces it."""
    _wrap_forward(stage.models["layer_vggish"], lambda taps: taps[:-1] + [taps[-1] * 1.01])


def extract_half_batch(stage):
    """Only the first half of each batch is computed; the rest reads zero."""
    def half(taps):
        out = []
        for t in taps:
            t = t.clone()
            t[t.shape[0] // 2:] = 0
            out.append(t)
        return out

    _wrap_forward(stage.models["layer_slowfast"], half)


def cluster_unchanged_state(stage):
    """A training step that returns its state unchanged."""
    def step(state, batch, lr, *args, **kwargs):
        return state, torch.zeros(batch.shape[0], device=batch.device)

    stage._train_step = step


def cluster_half_batch(stage):
    """Each training step sees the first half of its batch only."""
    orig = stage._train_step

    def step(state, batch, lr, *args, **kwargs):
        return orig(state, batch[:, : batch.shape[1] // 2].contiguous(), lr, *args, **kwargs)

    stage._train_step = step


def cluster_altered_answer(stage):
    """Every 97th row's assignment moved to the next center."""
    from acav100m_torch.ops import kmeans

    orig = kmeans.assign_step

    def assign(state, batch, *args, **kwargs):
        best = orig(state, batch, *args, **kwargs).clone()
        best[:, ::97] = (best[:, ::97] + 1) % state.centers.shape[1]
        return best

    kmeans.assign_step = assign
    stage_close = stage.close

    def close():
        kmeans.assign_step = orig
        stage_close()

    stage.close = close


def select_altered_answer(stage):
    """Every 5th iteration takes its batch's worst candidates."""
    from acav100m_torch.ops import mi

    orig = mi.stable_top_k
    calls = [0]

    def top_k(scores, k):
        calls[0] += 1
        if calls[0] % 5 == 1:
            vals, idx = orig(-scores, k)
            return -vals, idx
        return orig(scores, k)

    mi.stable_top_k = top_k
    stage_close = stage.close

    def close():
        mi.stable_top_k = orig
        stage_close()

    stage.close = close


FAULTS = {
    "extract": {"altered_answer": extract_altered_answer, "half_batch": extract_half_batch},
    "cluster": {"unchanged_state": cluster_unchanged_state, "half_batch": cluster_half_batch,
                "altered_answer": cluster_altered_answer},
    "select": {"altered_answer": select_altered_answer},
}
