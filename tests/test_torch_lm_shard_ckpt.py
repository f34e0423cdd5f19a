"""Sharded LM states through checkpoints, the elastic driver, the serving
steps and the training entry point, on the CPU over gloo: one world of 4
ranks spawned once (tests/torch_lm_shard_worker.py, ``job="ckpt"``)
beside ``torchrun`` running ``launch.train`` in a world of 2, and the
one-device arms in this process on one thread. Tiny
deepseek-v2-lite-16b (MLA, MoE with its "experts" axis) in f32 with f32
gradients, lr 5e-3, ``SyntheticLM`` batches of 4 × 32, from the port's
own ``LM(seed=0)`` parameters.

The contract, per test (the limits are ``test_torch_lm_shard.py``'s (b)
against the one-device step: losses within 1e-6 relative, the update
distance ‖p − p₁‖ / ‖p₁ − p₀‖ ≤ 1e-4):

* (d) a (2, 2) run checkpoints at step 2 (``save(..., shardings=)``: the
  whole leaves, written once) and takes step 3; a (1, 2) mesh of ranks 0
  and 1 and one device each restore it (``restore(..., shardings=)``):
  both restore the (2, 2) run's step-2 parameters bit for bit, the (1, 2)
  resume ends within the limits of the one-device resume (its "model"
  axis splits the dense FFN and the vocabulary, so its sums run in
  another order), and the one-device resume within the limits of the
  uninterrupted (2, 2) run;
* ``run_elastic`` over the world of 4, on ``make_mesh_for(4, 2)`` = (2, 2)
  until a ``SimulatedFailure`` at step 3, restarts on ``make_mesh_for(2,
  2)`` = (1, 2) from its step-2 checkpoint under the new shardings;
  ranks 2 and 3 leave (``RunReport.left``); the 5-step run ends within
  the limits of the one-device run;
* (e) prefill of 28 tokens then 4 decode steps on a (2, 1) mesh (each
  rank its 2 rows; parameters gathered; MoE routing over the whole
  batch) for yi-9b, deepseek-v2-lite-16b and zamba2-1.2b in f32: every
  logit within 1e-5 of the one-device logits' largest;
* (f) ``torchrun --nproc-per-node 2 -m repro_torch.launch.train --device
  cpu --mesh 2x1`` exits 0, prints the reference's lines once and leaves
  the whole state's checkpoint.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_lm_shard_worker as W
from repro_torch import configs as TC
from repro_torch.checkpoint import latest_step
from repro_torch.models import model as TM

HERE = os.path.dirname(os.path.abspath(__file__))
CLI_TIMEOUT_S = 240
SERVE_TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("lm_shard_ckpt"))
    inp = {f"{a}|{n}": p.detach().numpy() for a in W.ARCHS
           for n, p in TM.LM(TC.get_tiny(a), seed=0,
                             device="cpu").named_parameters()}
    np.savez(os.path.join(workdir, "inputs.npz"), **inp)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"), HERE]))
    cli_dir = os.path.join(workdir, "cli")
    cli = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "yi-9b", "--tiny", "--steps", "3", "--seq", "16",
         "--batch", "2", "--device", "cpu", "--mesh", "2x1", "--ckpt-dir",
         cli_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    started = W.start_world(4, workdir, "ckpt")
    out = {"inputs": inp, "p0": np.concatenate(
        [v.reshape(-1) for k, v in inp.items()
         if k.startswith(W.CKPT_ARCH + "|")])}
    tc = W.train_config("f32")
    with W.one_thread():
        out["one"] = W.train(inp, W.CKPT_ARCH, "f32")
        out["one_elastic"] = W.train(inp, W.CKPT_ARCH, "f32",
                                     steps=W.ELASTIC_STEPS)
        out["serve"] = {a: W.serve(inp, None, a) for a in W.ARCHS}
        out["ranks"] = W.join_world(started)
        out["resume1"] = W.resume(os.path.join(workdir, "run"), None, tc,
                                  W.CKPT_STEP, W.STEPS)
    stdout, stderr = cli.communicate(timeout=CLI_TIMEOUT_S)
    out["cli"] = (cli.returncode, stdout, stderr, cli_dir)
    return out


def _dist(a, b, p0) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b - p0))


def test_checkpoint_of_a_sharded_run_resumes_on_other_meshes(runs):
    r0 = runs["ranks"][0]
    full, one, pair = r0["full_params"], runs["resume1"], {
        k[len("resume12_"):]: v for k, v in r0.items()
        if k.startswith("resume12_")}
    np.testing.assert_array_equal(one["restored"], r0["full_saved"])
    np.testing.assert_array_equal(pair["restored"], r0["full_saved"])
    dp = _dist(pair["params"], one["params"], runs["p0"])
    rp = np.abs(pair["losses"] / one["losses"] - 1).max()
    print(f"(1, 2) resume against the one-device resume: update distance "
          f"{dp:.3g}, losses {rp:.3g} relative")
    assert dp <= 1e-4 and rp <= 1e-6
    d = _dist(one["params"], full, runs["p0"])
    rel = abs(one["losses"][-1] / r0["full_losses"][-1] - 1)
    print(f"resumed against the uninterrupted (2, 2) run: update "
          f"distance {d:.3g}, last loss {rel:.3g} relative")
    assert d <= 1e-4 and rel <= 1e-6


def test_elastic_restart_on_a_smaller_mesh(runs):
    ranks = runs["ranks"]
    assert [bool(r["elastic_left"]) for r in ranks] == [False, False,
                                                        True, True]
    for r in ranks:
        assert int(r["elastic_restarts"]) == 1
        assert r["elastic_meshes"].tolist() == [[2, 2], [1, 2]]
    assert int(ranks[0]["elastic_steps"]) == W.ELASTIC_STEPS
    np.testing.assert_array_equal(ranks[0]["elastic_params"],
                                  ranks[1]["elastic_params"])
    want = runs["one_elastic"]["params"]
    d = _dist(ranks[0]["elastic_params"], want, runs["p0"])
    print(f"elastic run against the one-device run: update distance "
          f"{d:.3g}")
    assert d <= 1e-4


@pytest.mark.parametrize("arch", W.ARCHS)
def test_prefill_and_decode_on_a_data_mesh(runs, arch):
    want = runs["serve"][arch]
    got = np.concatenate([r[f"serve_{arch}"] for r in runs["ranks"][:2]])
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print(f"{arch}: max|Δlogits| {err:.3g} of {scale:.3g}")
    assert got.shape == want.shape
    assert err <= SERVE_TOL * scale


def test_train_cli_in_a_world_of_two(runs):
    rc, stdout, stderr, cli_dir = runs["cli"]
    assert rc == 0, stderr[-3000:]
    print(stdout)
    assert stdout.count("params on mesh (2, 1)") == 1
    assert stdout.count("3 steps in") == 1
    assert latest_step(cli_dir) == 3
