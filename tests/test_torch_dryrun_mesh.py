"""The dry run on meshes (``repro_torch.launch.dryrun``): this process as
rank 0 of a fake world against a real gloo world of 4 running the same
step (tests/torch_lm_shard_worker.py, job ``collectives``), the memory
tracker against the Layouts' bytes, the records and the parameter and
model-flop counts against the reference's (tests/torch_dryrun_reference.py
in a subprocess: importing ``repro.launch.dryrun`` forces 512 host
devices on its process), and the CLI.

Every comparison is exact but one: the lasso screen cell's fused bytes
against the reference's HBM bytes of the same cell, 4 296 015 884
against 4 295 688 196 (7.6e-5 apart, read on a CPU), held within 1e-3.

The cells that claim the card run on fake CUDA tensors, which a torch
built without CUDA cannot index; the module's tests lend it a no-op
guard (tests/torch_fake_cuda.py).
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_lm_shard_worker as W
from repro_torch import configs as TC
from repro_torch import pshard
from repro_torch.launch import dryrun, hlo_cost
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     production_mesh_shape)
from repro_torch.models import model as M
from repro_torch.train import steps as ST
from torch_fake_cuda import cuda_guard

HERE = os.path.dirname(os.path.abspath(__file__))
MESH = pshard.MeshShape(("data", "model"), (2, 2))
SHAPE = TC.ShapeSpec("t", "train", W.SEQ, W.BATCH)


@pytest.fixture(scope="module", autouse=True)
def fake_cuda():
    with cuda_guard():
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"world": the gloo world's rank results, "ref": the reference's
    numbers}: the reference's subprocess and the world run at once."""
    workdir = str(tmp_path_factory.mktemp("dryrun_mesh"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"), HERE]))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dryrun_reference.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    np.savez(os.path.join(workdir, "inputs.npz"))      # the job reads none
    world = W.join_world(W.start_world(4, workdir, "collectives"))
    log, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    return {"world": world, "ref": json.loads(log.strip().splitlines()[-1])}


@pytest.mark.parametrize("arch", list(TC.ARCHS))
def test_param_counts_equal_the_reference(runs, arch):
    got = list(dryrun.param_counts(TC.get_config(arch)))
    assert got == runs["ref"]["params"][arch]


@pytest.mark.parametrize("arch", list(TC.ARCHS))
def test_model_flops_equal_the_reference(runs, arch):
    for shape in TC.SHAPES:
        assert (dryrun.model_flops(arch, shape)
                == runs["ref"]["model_flops"][f"{arch}|{shape}"])


def _traced_on_world(arch: str) -> dict:
    """One default (bf16) train step of the tiny ``arch`` traced as rank 0
    of a fake world of 4 on a (2, 2) mesh."""
    with dryrun.fake_world(4):
        mesh = make_mesh(MESH, "cpu")
        return dryrun.trace_step(TC.get_tiny(arch), SHAPE, mesh,
                                 ST.TrainConfig(), device="cpu")


@pytest.mark.parametrize("arch", W.COLLECTIVE_ARCHS)
def test_a_fake_world_issues_a_real_worlds_collectives(runs, arch):
    """Rank 0's collectives by kind (calls, bytes contributed) in the
    fake world equal rank 0's in a gloo world of 4 running the same
    step; the ring model's bytes follow from them."""
    traced = _traced_on_world(arch)
    real = {k.split("|")[1]: tuple(int(x) for x in v)
            for k, v in runs["world"][0].items()
            if k.startswith(arch + "|")}
    assert dryrun.hlo.contributions(traced["mode"].records) == real
    cost = traced["mode"].cost
    gathered = real["all_gather"][1]
    assert cost.coll_bytes_by_kind["all-reduce"] == 2 * real["all_reduce"][1]
    assert cost.coll_counts == {dryrun.hlo.KINDS[k]: calls
                                for k, (calls, _) in real.items()}
    assert set(real) == {"all_gather", "all_reduce", "reduce_scatter"}
    assert 0 < cost.coll_bytes_by_kind["all-gather"] <= 3 * gathered


def _layout_bytes(cfg, mesh_shape) -> int:
    """The rank's f32 master bytes by the Layouts alone (no world)."""
    specs = M.param_specs(cfg)
    shapes = dict(M.LM(cfg, device="meta").named_parameters())
    lay = pshard.resolve_tree(mesh_shape, specs, shapes)
    return 4 * sum(math.prod(lay[k].local_shape) for k in lay)


@pytest.mark.parametrize("arch", W.COLLECTIVE_ARCHS)
def test_the_tracker_holds_the_layouts_bytes(arch):
    """The tracked step's parameters are the rank's master shards and its
    optimizer state both moments of them (and the two step counters),
    byte for byte what the Layouts give; the peak holds them."""
    mem = _traced_on_world(arch)["memory"]
    want = _layout_bytes(TC.get_tiny(arch), MESH)
    by = mem["peak_by_category_gb"]
    assert round(by["parameters"] * 1e9) == want
    assert round(by["optimizer"] * 1e9) == 2 * want + 8
    assert round(mem["argument_gb"] * 1e9) == 3 * want + 8 + round(
        by["inputs"] * 1e9)
    assert mem["peak_per_device_gb"] >= mem["argument_gb"]
    assert mem["alias_gb"] > 0                  # the state updated in place


# per-rank f32 masters + m + v on (16, 16), GiB (chip_smoke.py phase
# 23(c)'s arithmetic, PERF.md §6)
STATE_GIB = {"yi-9b": 0.51, "deepseek-v2-lite-16b": 0.74,
             "nemotron-4-340b": 18.49}


@pytest.mark.parametrize("arch", list(STATE_GIB))
def test_full_width_state_specs_on_the_production_mesh(arch):
    """The dry run's state at full width on (16, 16): the rank's fake
    shards hold the Layouts' bytes, phase 23(c)'s per-rank GiB."""
    cfg = TC.get_config(arch)
    with dryrun.fake_world(256):
        mesh = make_production_mesh(device_type="cuda")
        with hlo_cost.fake_mode():
            state, sh = SP.state_struct(cfg, ST.TrainConfig(), mesh,
                                        device="cuda")
            held = sum(t.numel() * t.element_size() for t in (
                *state.params.parameters(), *state.opt.m.values(),
                *state.opt.v.values()))
    want = 3 * _layout_bytes(cfg, production_mesh_shape())
    assert held == want
    assert f"{want / 2**30:.2f}" == f"{STATE_GIB[arch]:.2f}"
    assert all(t.device.type == "cuda" for t in state.params.parameters())


DOCUMENTED = {"added": {"device", "trace_s", "kernels", "dot_flops"},
              "dropped": {"compile_s"},
              "memory": {"peak_by_category_gb"},
              "collectives": {"contributed"}}


def _check_keys(rec: dict, ref: dict) -> None:
    assert set(rec) - set(ref) == DOCUMENTED["added"]
    assert set(ref) - set(rec) == DOCUMENTED["dropped"]
    assert set(rec["memory"]) - set(ref["memory"]) == DOCUMENTED["memory"]
    assert set(ref["memory"]) <= set(rec["memory"])
    assert set(rec["roofline"]) == set(ref["roofline"])
    assert (set(rec["collectives"]) - set(ref["collectives"])
            == DOCUMENTED["collectives"])
    assert rec["xla_cost"] is None


def test_records_keep_the_reference_keys(runs):
    """A lasso cell's record has the reference's keys but the documented
    ones, and its collectives and fused bytes are the reference's; an LM
    cell's adds the reference's params, model_flops and
    useful_flops_ratio."""
    ref = runs["ref"]["lasso_record"]
    rec = dryrun.run_cell("lasso-screen-16m", "lasso", False, device="cuda")
    _check_keys(rec, ref)
    assert rec["collectives"]["counts"] == ref["collectives"]["counts"]
    assert (rec["collectives"]["bytes_by_kind"]
            == ref["collectives"]["bytes_by_kind"])
    assert abs(rec["roofline"]["hbm_bytes"] / ref["roofline"]["hbm_bytes"]
               - 1) <= 1e-3
    assert rec["kernels"]["edpp_screen_scores"]["launches"] == 1
    lm = dryrun.cell_record("yi-9b", "train_4k", MESH.dims,
                            _traced_on_world("yi-9b"))
    _check_keys({k: v for k, v in lm.items()
                 if k not in ("params", "model_flops", "useful_flops_ratio")},
                ref)
    assert lm["model_flops"] == runs["ref"]["model_flops"]["yi-9b|train_4k"]


def test_the_cli_traces_skips_and_records_failures(tmp_path, monkeypatch):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "lasso-fista-16m", "--mesh", "both",
                        "--out", out, "--device", "cuda"]) == 0
    for mesh, chips in (("16x16", 256), ("2x16x16", 512)):
        with open(os.path.join(out, f"lasso-fista-16m__lasso__{mesh}.json")
                  ) as f:
            rec = json.load(f)
        assert rec["status"] == "ok" and rec["chips"] == chips
        assert rec["kernels"]["prox_step"]["launches"] == 10
        assert rec["collectives"]["counts"] == {"all-reduce": 40}
    assert dryrun.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                        "--mesh", "single", "--out", out]) == 0
    with open(os.path.join(out, "hubert-xlarge__decode_32k__16x16.json")) as f:
        assert json.load(f)["status"] == "skipped"

    def boom(*a, **k):
        raise RuntimeError("boom")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    assert dryrun.main(["--arch", "lasso-screen-16m", "--mesh", "both",
                        "--out", out]) == 1
    with open(os.path.join(out, "lasso-screen-16m__lasso__2x16x16.json")) as f:
        rec = json.load(f)
    assert rec["status"] == "error" and "boom" in rec["traceback"]


def test_the_cli_claims_the_card_only_where_torch_has_cuda(tmp_path):
    """Without ``--device`` the CLI claims the card where torch is built
    with CUDA and traces the CPU path where it is not; the record says
    which. The CPU path's screen issues the card's collectives and runs
    the kernels' plain versions, so it charges no kernel."""
    out = str(tmp_path)
    assert dryrun.main(["--arch", "lasso-screen-16m", "--mesh", "single",
                        "--out", out]) == 0
    with open(os.path.join(out, "lasso-screen-16m__lasso__16x16.json")) as f:
        rec = json.load(f)
    built = torch.backends.cuda.is_built()
    assert rec["status"] == "ok"
    assert rec["device"] == ("cuda" if built else "cpu")
    assert rec["collectives"]["counts"] == {"all-reduce": 1}
    assert bool(rec["kernels"]) == built
