"""Record the JAX package's batched greedy selection on the parity pool
(``batch_mi_states.PARITY``) in float32, for the card's test of the fused
step (``tests/test_torch_cuda.py``), which runs where JAX is not installed:
for ``keep_unselected`` True and False, the picks in order, their gains and
the final cache (N, a, b, n).

Run:  python -m tests.gen_batch_greedy_jax
Writes tests/data/batch_greedy_jax.npz (committed);
``tests/test_torch_mi.py`` holds the file to what the JAX package gives.
"""

from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

from . import batch_mi_states as bm  # noqa: E402

KEEP = (True, False)


def jax_run(keep_unselected: bool) -> dict:
    from acav100m_tpu.ops import mi as jmi
    from acav100m_tpu.ops.pairing import get_cluster_pairing

    p = bm.PARITY
    combos = get_cluster_pairing([(str(i), "x") for i in range(p["d"])], "combination")
    sel = jmi.BatchGreedySelector(bm.parity_assignments(), combos, ncentroids=p["c"],
                                  batch_size=p["batch_size"],
                                  selection_size=p["selection_size"],
                                  keep_unselected=keep_unselected,
                                  rng=np.random.RandomState(p["rng_seed"]), dtype="float32")
    picks, gains, _, _ = sel.run_greedy(p["subset"], p["start"])
    out = {"picks": np.asarray(picks, np.int64), "gains": np.asarray(gains, np.float64)}
    out.update({key: np.asarray(sel.cache[key]) for key in ("N", "a", "b", "n")})
    return out


def main() -> None:
    arrays = {bm.record_key(keep, name): value for keep in KEEP
              for name, value in jax_run(keep).items()}
    bm.JAX_RECORD.parent.mkdir(exist_ok=True)
    np.savez_compressed(bm.JAX_RECORD, **arrays)
    print(f"wrote {bm.JAX_RECORD}: {sorted(arrays)}")


if __name__ == "__main__":
    main()
