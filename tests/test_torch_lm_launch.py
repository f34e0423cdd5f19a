"""The LM stack's entry point, checkpoints and elastic driver on the CPU:

* ``python -m repro_torch.launch.train --tiny --device cpu`` runs, and a
  run resumed from its checkpoint ends bit for bit where an
  uninterrupted run ends (losses and every leaf of the state);
* a port ``TrainState`` checkpoint restores in ``repro.checkpoint.
  restore`` into the reference's ``TrainState``, and a reference
  checkpoint restores in the port, leaf for leaf; the CLI resumes from
  a reference checkpoint;
* ``run_elastic`` recovers from ``SimulatedFailure``s;
* the example twins run.
"""

import os
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch
from jax.sharding import Mesh

from repro import checkpoint as jckpt
from repro import configs as JC
from repro.data import device_batch
from repro.optim import adamw as JA
from repro.train import steps as JST
from repro_torch import checkpoint as tckpt
from repro_torch import configs as TC
from repro_torch.convert import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.data import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.runtime import ElasticConfig, SimulatedFailure, run_elastic
from repro_torch.train import steps as TST

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = ["--arch", "yi-9b", "--tiny", "--seq", "16", "--batch", "2",
       "--device", "cpu"]


def _leaves(state):
    return jax.tree.leaves(train_state_to_reference(state))


def test_train_cli_resume_equals_uninterrupted(tmp_path, capsys):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    full, losses = launch_train.main(CLI + ["--steps", "6", "--ckpt-dir", a,
                                            "--ckpt-every", "3"])
    assert tckpt.latest_step(a) == 6
    _, first = launch_train.main(CLI + ["--steps", "3", "--ckpt-dir", b])
    resumed, rest = launch_train.main(CLI + ["--steps", "6", "--ckpt-dir",
                                             b])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "tok/s" in out
    assert list(first) == [0, 1, 2] and list(rest) == [3, 4, 5]
    assert {**first, **rest} == losses
    assert int(resumed.step) == int(full.step) == 6
    for x, y in zip(_leaves(full), _leaves(resumed)):
        np.testing.assert_array_equal(x, y)


def test_train_cli_refuses_what_is_not_ported():
    """``--mesh 2x1`` in a world of one process exits naming
    ``torchrun``."""
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node=2"):
        launch_train.main(CLI + ["--steps", "1", "--mesh", "2x1"])


def _reference_state(steps: int):
    """The reference's TrainState after ``steps`` steps of its own train
    step on an auto-typed 1×1 mesh (tiny yi-9b, the CLI's batches)."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    cfg = JC.get_tiny("yi-9b")
    tc = JST.TrainConfig(opt=JA.OptConfig(lr=3e-4, warmup_steps=2,
                                          total_steps=100))
    state, sh = JST.init_state(jax.random.PRNGKey(0), cfg, tc, mesh)
    src = SyntheticLM(vocab=cfg.vocab, seq=16, global_batch=2)
    b0 = device_batch(mesh, src.host_batch(0))
    step = JST.make_train_step(cfg, tc, mesh, sh,
                               {k: v.sharding for k, v in b0.items()})
    for i in range(steps):
        state, _ = step(state, device_batch(mesh, src.host_batch(i)))
    return state


def test_checkpoints_cross_between_packages(tmp_path):
    cfg = TC.get_tiny("yi-9b")
    jstate = _reference_state(2)
    # reference → port
    jckpt.save(str(tmp_path / "j"), 2, jstate)
    like = train_state_to_reference(TST.init_state(
        5, cfg, TST.TrainConfig(), device="cpu")[0])
    tree, _ = tckpt.restore(str(tmp_path / "j"), 2, like, device="cpu")
    port = train_state_from_reference(tree, cfg, device="cpu")
    want = [np.asarray(x) for x in jax.tree.leaves(jstate)]
    got = _leaves(port)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype and w.shape == g.shape
        np.testing.assert_array_equal(w, g)
    # port → reference
    tckpt.save(str(tmp_path / "t"), 2, train_state_to_reference(port))
    back, _ = jckpt.restore(str(tmp_path / "t"), 2, jstate)
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    for w, g in zip(want, jax.tree.leaves(back)):
        np.testing.assert_array_equal(w, np.asarray(g))


def test_train_cli_resumes_from_a_reference_checkpoint(tmp_path, capsys):
    d = str(tmp_path)
    jckpt.save(d, 3, _reference_state(3))
    state, losses = launch_train.main(CLI + ["--steps", "5", "--ckpt-dir",
                                             d])
    assert "resumed from step 3" in capsys.readouterr().out
    assert list(losses) == [3, 4] and np.isfinite(list(losses.values())).all()
    assert int(state.step) == int(state.opt.step) == 5
    assert tckpt.latest_step(d) == 5


def test_elastic_recovers_from_failures(tmp_path):
    """Failures at steps 7 and 13: the driver restores and finishes, and
    the final state equals an uninterrupted run's."""
    fail_at, seen = {7, 13}, []

    def restore_fn(mesh, step):
        state, _ = tckpt.restore(str(tmp_path), step,
                                 {"x": torch.zeros(())}, device="cpu")
        return state

    def step_fn(mesh, state, step):
        if step in fail_at and step not in seen:
            seen.append(step)
            raise SimulatedFailure(f"worker lost at {step}")
        return {"x": state["x"] + (step + 1)}

    report = run_elastic(
        ElasticConfig(ckpt_dir=str(tmp_path), ckpt_every=5),
        make_mesh=lambda attempt: None,
        init_fn=lambda mesh: {"x": torch.zeros(())},
        restore_fn=restore_fn, step_fn=step_fn,
        save_fn=lambda state, step: state, total_steps=20)
    assert report.restarts == 2 and report.steps_done == 20
    final, _ = tckpt.restore(str(tmp_path), 20, {"x": torch.zeros(())},
                             device="cpu")
    assert float(final["x"]) == sum(range(1, 21))


def test_elastic_drives_the_train_step(tmp_path):
    """A failure mid-run restores the train state from its checkpoint and
    ends where an uninterrupted run ends, bit for bit."""
    cfg = TC.get_tiny("yi-9b")
    tc = TST.TrainConfig()
    step = TST.make_train_step(cfg, tc)
    src = SyntheticLM(vocab=cfg.vocab, seq=16, global_batch=2)
    from repro_torch.data import to_device

    def run(ckpt_dir, fail):
        seen = []

        def step_fn(mesh, state, i):
            if i == fail and not seen:
                seen.append(i)
                raise SimulatedFailure("lost")
            return step(state, to_device(src.host_batch(i), "cpu"))[0]

        def restore_fn(mesh, s):
            like = train_state_to_reference(TST.init_state(
                0, cfg, tc, device="cpu")[0])
            tree, _ = tckpt.restore(ckpt_dir, s, like, device="cpu")
            return train_state_from_reference(tree, cfg, device="cpu")

        box = {}

        def save_fn(state, s):
            box["state"] = state
            return train_state_to_reference(state)

        rep = run_elastic(
            ElasticConfig(ckpt_dir=ckpt_dir, ckpt_every=2),
            make_mesh=lambda attempt: None,
            init_fn=lambda mesh: TST.init_state(0, cfg, tc,
                                                device="cpu")[0],
            restore_fn=restore_fn, step_fn=step_fn, save_fn=save_fn,
            total_steps=5)
        return rep, box["state"]

    rep_a, a = run(str(tmp_path / "a"), fail=-1)
    rep_b, b = run(str(tmp_path / "b"), fail=3)
    assert (rep_a.restarts, rep_b.restarts) == (0, 1)
    for x, y in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(x, y)


def test_elastic_budget_exhausted(tmp_path):
    def step_fn(mesh, state, step):
        raise SimulatedFailure("always")
    with pytest.raises(RuntimeError, match="restart budget"):
        run_elastic(ElasticConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                                  max_restarts=2),
                    make_mesh=lambda a: None,
                    init_fn=lambda m: {"x": torch.zeros(())},
                    restore_fn=lambda m, s: {"x": torch.zeros(())},
                    step_fn=step_fn, save_fn=lambda s, t: s, total_steps=5)


def _run_example(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, *args], capture_output=True,
                         text=True, env=env, timeout=timeout, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_lm_torch_example_runs(tmp_path):
    out = _run_example(["examples/train_lm_torch.py", "--tiny", "--steps",
                        "2", "--seq", "32", "--device", "cpu", "--ckpt-dir",
                        str(tmp_path)])
    assert "model lm-tiny" in out and "done; checkpoints" in out
    assert tckpt.latest_step(str(tmp_path)) == 2


def test_prune_ffn_torch_example_runs():
    out = _run_example(["examples/prune_ffn_torch.py", "--device", "cpu",
                        "--solver-tol", "1e-6"])
    assert "trained tiny LM to loss" in out
    assert "neurons kept" in out and "SAFELY" in out
