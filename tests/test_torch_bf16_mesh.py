"""Mesh sessions in mixed precision and across dictionary updates, on the
CPU over gloo: in-process at world size 1 (a 1×1 mesh), and in worlds of
2 ranks (1×2) and 4 ranks (2×2: two query rows of two feature shards),
spawned once, at the same time, through tests/torch_dist_worker.py
(``job="mixed"``, :func:`torch_dist_worker.compute_mixed`).

The contract, per test:

* ``screen_dtype="bfloat16"`` on a mesh: for every rule of
  ``BF16_FAST_RULES``, one query and a (4, n) batch, the masks equal the
  same mesh's float32 masks bit for bit; every screened step streams
  bf16; the band's f32 re-test ran (fallback columns > 0 over the rules);
* ``solve_dtype="bfloat16"`` on a mesh (``fista`` and ``cd`` on one
  query, ``fista`` on the batch): masks equal the unsharded bf16-solve
  session's outside BAND of the EDPP threshold either path tested
  (flips counted), β within ``beta_err_tol(y, 1e-6)``, every live step
  ``solve_dtype_effective == "bfloat16"`` with bf16-phase iterations (a
  ``cd`` bucket past the Gram crossover: float32), as the unsharded
  session's steps;
* ``session.update`` on a mesh (balanced with the argmax of a live
  query dropped, a compacting drop, an append, a mixed edit, in turn):
  the edited X, ‖x_j‖², ‖x_j‖, the bf16 copy and ``:err``, the live
  batch workspace's |Xᵀy|, argmax and λ_max, the reports and the path
  after ``reset_solver_cache()`` (masks, β, ``geometry_version``) equal
  the unsharded session's update bit for bit; an edit to a width the
  feature axis cannot split is refused.

The unsharded arms run in this process with one thread, as each rank
of the spawned worlds does.
"""

import contextlib
import os

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from repro.data.pipeline import lasso_problem
from repro_torch.core.engine import BF16_FAST_RULES
from test_torch_update import outside_band

MESHES = {1: (1, 1), 2: (1, 2), 4: (2, 2)}
WORLDS = (1, 2, 4)


@contextlib.contextmanager
def one_thread():
    """torch on one thread here, as on every spawned rank."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    Xs, ys, _ = lasso_problem(50, 400, nnz=10, seed=4, dtype=np.float32)
    rng = np.random.default_rng(5)
    W = np.zeros((4, Xs.shape[1]))
    for w in W:
        w[rng.choice(Xs.shape[1], 10, replace=False)] = rng.uniform(-1, 1, 10)
    Ys = (W @ Xs.T.astype(np.float64)
          + 0.1 * rng.standard_normal((4, Xs.shape[0]))).astype(np.float32)
    istar = int(np.argmax(np.abs(Xs.T.astype(np.float64) @ Ys[0])))
    rng = np.random.default_rng(9)
    return dict(
        Xs=Xs, ys=ys, Ys=Ys,
        add=rng.standard_normal((Xs.shape[0], 16)).astype(np.float32),
        drop_bal=np.array([istar, 7, 150, 333]),
        drop_only=np.array([0, 9, 200, 395]),
        drop_mixed=np.array([1, 2, 3, 399]))


@pytest.fixture(scope="module")
def worlds(problem, tmp_path_factory):
    """World size → :func:`torch_dist_worker.compute_mixed`'s results: 1
    in-process, 2 and 4 in spawned worlds run at the same time."""
    workdir = str(tmp_path_factory.mktemp("mixed"))
    np.savez(os.path.join(workdir, "inputs.npz"), **problem)
    started = [worker.start_world(w, MESHES[w], workdir, "mixed")
               for w in (2, 4)]
    with one_thread(), worker.one_rank() as mesh:
        results = {1: worker.compute_mixed(mesh, problem)}
    for w, s in zip((2, 4), started):
        results[w] = worker.join_world(s)
    return results


@pytest.fixture(scope="module")
def unsharded(problem):
    """The same session arms without a mesh (no screen arms: those are
    held to the same mesh's float32 arm)."""
    with one_thread():
        return worker.compute_mixed(None, problem, screens=False)


@pytest.mark.parametrize("rule", BF16_FAST_RULES)
@pytest.mark.parametrize("world", WORLDS)
def test_bf16_screen_on_a_mesh_gives_its_float32_masks(worlds, world, rule):
    out = worlds[world]
    for tag in ("one", "batch"):
        f32 = out[f"screen_{rule}_{tag}_float32"]
        bf16 = out[f"screen_{rule}_{tag}_bfloat16"]
        assert f32.shape == bf16.shape
        np.testing.assert_array_equal(bf16, f32, err_msg=f"{rule}/{tag}")
        stats = out[f"screen_{rule}_{tag}_stats"]
        assert stats.size and stats[:, 0].all(), (rule, tag)


@pytest.mark.parametrize("world", WORLDS)
def test_bf16_mesh_screens_retest_their_band(worlds, world):
    """The f32 re-test ran: over the rules, the band held columns."""
    out = worlds[world]
    total = sum(int(out[f"screen_{rule}_{tag}_stats"][:, 1].sum())
                for rule in BF16_FAST_RULES for tag in ("one", "batch"))
    print(f"world {world}: {total} band columns re-tested in float32")
    assert total > 0


@pytest.mark.parametrize("arm", worker.SOLVE_ARMS,
                         ids=["_".join(a) for a in worker.SOLVE_ARMS])
@pytest.mark.parametrize("world", WORLDS)
def test_bf16_solve_on_a_mesh_matches_unsharded(problem, worlds, unsharded,
                                                world, arm):
    strategy, tag = arm
    key = f"solve_{strategy}_{tag}"
    out = worlds[world]

    def result(src):
        from repro_torch.core.path import PathResult
        return PathResult(lambdas=src[f"{key}_lambdas"],
                          betas=src[f"{key}_betas"], stats=[],
                          masks=src[f"{key}_masks"])

    Y = problem["ys"] if tag == "one" else problem["Ys"]
    outside_band(problem["Xs"], Y, result(out), result(unsharded),
                 f"world {world} bf16 {strategy}/{tag}")
    stats = out[f"{key}_stats"]
    np.testing.assert_array_equal(stats, unsharded[f"{key}_stats"])
    if strategy == "cd":       # a bucket past the Gram crossover: float32
        stats = stats[stats[:, 2] <= min(problem["Xs"].shape[0], 1024)]
    assert stats.size and stats[:, 0].all(), "every live step in bf16"
    assert stats[:, 1].sum() > 0, "bf16-phase iterations"


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_update_equals_the_unsharded_update(worlds, unsharded, world):
    out = worlds[world]
    keys = ["err"] + [k for k in unsharded
                      if k.startswith("upd") and k != "update_indivisible"]
    assert len(keys) == 1 + 4 * 12
    for k in keys:
        np.testing.assert_array_equal(out[k], unsharded[k], err_msg=k)
    # balanced (the argmax of query 0 dropped), drop, append, mixed
    reports = [tuple(out[f"upd{i}_report"]) for i in range(4)]
    assert [r[:2] for r in reports] == [(1, 400), (2, 396), (3, 400),
                                        (4, 404)]
    assert reports[0][2] >= 1
    assert all((out[f"upd{i}_version"] == i + 1).all() for i in range(4))


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_update_refuses_a_width_it_cannot_split(worlds, world):
    msg = str(worlds[world]["update_indivisible"])
    if world == 1:
        assert msg == ""
    else:
        assert "not divisible by the mesh's feature size 2" in msg
