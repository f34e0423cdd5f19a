"""The port's launch layer on the CPU: ``repro_torch.launch.serve`` and
``repro_torch.launch.solve`` called in-process with ``--device cpu`` at
small sizes (their report lines, the pow-2 batch shapes of a 104-query
continuous run, a bench JSON written only where ``--bench-json`` says),
solve's printed λ_max and discard counts against the reference's ``solve
--no-x64`` (run in a subprocess, so no JAX setting changes here), the
refusals (``--x64`` on the card, the bf16 flags, no card, a mesh wider
than the process group), ``--mesh 1x1`` over gloo against the unsharded
run, and ``repro_torch.checkpoint`` against ``repro.checkpoint`` in both
directions.
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as tckpt
from repro_torch.launch import serve, solve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVE = ["--device", "cpu", "--n", "50", "--p", "400", "--nnz", "10",
         "--num-lambdas", "20"]
SERVE = ["--device", "cpu", "--n", "30", "--p", "64", "--b-max", "8",
         "--num-lambdas", "4", "--solver-tol", "1e-5"]


def test_serve_streams_104_queries_continuous(capsys):
    """As tests/test_system.py runs the reference: 104 = 13 × 8 eager
    queries form full fill batches only, one padded batch shape."""
    out = serve.main(SERVE + ["--num-queries", "104", "--mode",
                              "continuous"])
    text = capsys.readouterr().out
    assert "served 104/104 queries" in text and "queries/sec" in text
    assert "latency p50" in text and "p99" in text and "errors 0" in text
    m = re.search(r"padded batch shapes \[([0-9, ]+)\]", text)
    assert m and m.group(1) == "8", text
    rep = out["reports"]["continuous"]
    assert [(r.reason, r.n_live, r.padded_b) for r in rep.trace] \
        == [("fill", 8, 8)] * 13
    assert rep.summary()["n_errors"] == 0


def test_serve_compare_writes_only_the_bench_json_it_is_given(tmp_path,
                                                              capsys):
    bench = tmp_path / "serve.json"
    before = {f: os.stat(os.path.join(REPO, f)).st_mtime_ns
              for f in os.listdir(REPO) if f.startswith("BENCH_")}
    out = serve.main(SERVE + ["--num-queries", "12", "--b-max", "4",
                              "--mode", "compare", "--repeats", "1",
                              "--check-masks", "0", "--bench-json",
                              str(bench)])
    text = capsys.readouterr().out
    assert out["masks_identical"] == {"fixed": True, "continuous": True}
    assert out["mismatched"] == {"fixed": [], "continuous": []}
    assert out["session"].fit_passes == 1
    assert out["ratio"] > 0 and f"wrote {bench}" in text
    assert text.count("served 12/12 queries") == 2
    for mode in ("fixed", "continuous"):
        assert out["reports"][mode].summary()["n_ok"] == 12
    rows = json.loads(bench.read_text())["sections"]["bench_serve"]["rows"]
    assert [r["mode"] for r in rows] == ["fixed", "continuous"]
    assert all(r["masks_identical"] and r["n_errors"] == 0 for r in rows)
    assert before == {f: os.stat(os.path.join(REPO, f)).st_mtime_ns
                      for f in os.listdir(REPO) if f.startswith("BENCH_")}


def test_serve_refuses_the_references_bench_files():
    with pytest.raises(SystemExit, match="BENCH_"):
        serve.main(SERVE + ["--mode", "compare",
                            "--bench-json", "BENCH_serve.json"])


def _solve_lines(text):
    lmax = re.search(r"λmax=([0-9.]+)", text).group(1)
    counts = re.findall(r"discarded=\s*(\d+) kept=\s*(\d+)", text)
    return lmax, counts


def test_solve_prints_the_references_lambda_max_and_discards(capsys,
                                                             subproc):
    res = solve.main(SOLVE + ["--no-x64"])
    port = capsys.readouterr().out
    ref = subproc("from repro.launch.solve import main\n"
                  f"main({SOLVE[2:] + ['--no-x64']!r})\n", devices=1,
                  timeout=300)
    assert _solve_lines(port) == _solve_lines(ref), (port, ref)
    assert len(_solve_lines(port)[1]) == 10
    assert "rule=edpp solver=fista grid=20" in port
    assert re.search(r"path time [0-9.]+s \(screen [0-9.]+s\); dictionary "
                     r"fitted once \(fused passes: 1\)", port)
    assert res.betas.shape == (20, 400) and res.betas.dtype == np.float64


def test_solve_checkpoints_every_step(tmp_path):
    ckpt = tmp_path / "ckpt"
    res = solve.main(SOLVE + ["--no-x64", "--ckpt-dir", str(ckpt)])
    assert tckpt.latest_step(str(ckpt)) == 19
    assert sorted(os.listdir(ckpt)) == [f"step_{k:08d}" for k in (17, 18,
                                                                    19)]
    tree, extra = tckpt.restore(str(ckpt), 19, {"beta": 0}, device="cpu")
    assert tree["beta"].dtype == torch.float32
    np.testing.assert_array_equal(tree["beta"].numpy(), res.betas[-1])
    assert extra == {"lam": float(res.lambdas[-1])}


def test_solve_defaults_to_float64_on_the_cpu(capsys, tmp_path):
    res = solve.main(SOLVE[:-1] + ["5", "--ckpt-dir", str(tmp_path)])
    assert "grid=5" in capsys.readouterr().out
    tree, _ = tckpt.restore(str(tmp_path), 4, {"beta": 0}, device="cpu")
    assert tree["beta"].dtype == torch.float64
    np.testing.assert_array_equal(tree["beta"].numpy(), res.betas[-1])


def test_solve_group_path(capsys):
    res = solve.main(["--device", "cpu", "--no-x64", "--n", "50", "--p",
                      "400", "--nnz", "20", "--num-lambdas", "10",
                      "--group-size", "5"])
    text = capsys.readouterr().out
    assert "solver=group_fista" in text
    assert res.masks.shape == (10, 80)
    with pytest.raises(SystemExit, match="group solver strategy"):
        solve.main(["--device", "cpu", "--group-size", "5", "--solver",
                    "cd"])


@pytest.mark.parametrize("driver", [serve, solve])
def test_x64_on_the_card_exits(driver):
    with pytest.raises(SystemExit, match="--device cpu"):
        driver.main(["--device", "cuda", "--x64"])


@pytest.mark.parametrize("driver", [serve, solve])
def test_no_card_raises_without_falling_back(driver, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.main(["--n", "10", "--p", "20"])


@pytest.mark.parametrize("flag", ["--screen-dtype", "--solve-dtype"])
def test_bf16_flags_raise_naming_their_item(flag):
    with pytest.raises(NotImplementedError, match="item 9"):
        solve.main(SOLVE + ["--no-x64", flag, "bfloat16"])


def test_mesh_1x1_over_gloo_gives_the_unsharded_output(capsys):
    plain = solve.main(SOLVE + ["--no-x64"])
    meshed = solve.main(SOLVE + ["--no-x64", "--mesh", "1x1"])
    assert not torch.distributed.is_initialized()   # torn down after
    np.testing.assert_array_equal(meshed.masks, plain.masks)
    np.testing.assert_array_equal(meshed.betas, plain.betas)
    out = serve.main(SERVE + ["--num-queries", "9", "--mesh", "1x1"])
    rep = out["reports"]["continuous"]
    assert rep.summary()["n_ok"] == 9
    # the tail's reason ("deadline" or "drain") depends on the wall clock
    assert [(r.n_live, r.padded_b) for r in rep.trace] == [(8, 8), (1, 1)]
    with pytest.raises(SystemExit, match="torchrun"):
        solve.main(SOLVE + ["--no-x64", "--mesh", "2x2"])


# ---------------------------------------------------------------------------
# checkpoints, across both packages
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"z": rng.standard_normal(5).astype(np.float32),
            "a": [rng.standard_normal((2, 3)), None,
                  (np.arange(4, dtype=np.int32),)],
            "lam": np.float32(0.25)}


def _like():
    return {"z": 0, "a": [0, None, (0,)], "lam": 0}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_restores_in_the_other_package(tmp_path, writer):
    want = _tree(np.random.default_rng(0))
    if writer == "port":
        tckpt.save(str(tmp_path), 7, {
            "z": torch.from_numpy(want["z"]),
            "a": [torch.from_numpy(want["a"][0]), None,
                  (want["a"][2][0],)], "lam": want["lam"]},
            extra={"lam": 0.25})
        got, extra = jckpt.restore(str(tmp_path), 7, _like())
        got = {"z": got["z"], "a": [got["a"][0], None, (got["a"][2][0],)],
               "lam": got["lam"]}
        assert jckpt.latest_step(str(tmp_path)) == 7
    else:
        jckpt.save(str(tmp_path), 7, {
            "z": jnp.asarray(want["z"]),
            "a": [want["a"][0], None, (jnp.asarray(want["a"][2][0]),)],
            "lam": want["lam"]}, extra={"lam": 0.25})
        got, extra = tckpt.restore(str(tmp_path), 7, _like(), device="cpu")
        assert all(isinstance(x, torch.Tensor)
                   for x in (got["z"], got["a"][0], got["a"][2][0]))
        assert tckpt.latest_step(str(tmp_path)) == 7
    assert extra == {"lam": 0.25} and got["a"][1] is None
    np.testing.assert_array_equal(np.asarray(got["z"]), want["z"])
    np.testing.assert_array_equal(np.asarray(got["a"][2][0]),
                                  want["a"][2][0])
    np.testing.assert_allclose(np.asarray(got["a"][0]), want["a"][0],
                               rtol=2 ** -23)      # f64 → f32 in JAX
    assert float(np.asarray(got["lam"])) == 0.25


def test_checkpoint_keeps_three_and_ignores_an_uncommitted_step(tmp_path):
    d = str(tmp_path)
    for k in range(5):
        tckpt.save(d, k, {"beta": torch.full((3,), float(k))})
    assert sorted(os.listdir(d)) == [f"step_{k:08d}" for k in (2, 3, 4)]
    os.makedirs(os.path.join(d, "step_00000009"))       # no _DONE marker
    os.makedirs(os.path.join(d, "step_00000008.tmp"))
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 4
    with pytest.raises(FileNotFoundError):
        tckpt.restore(d, 9, {"beta": 0}, device="cpu")
    tree, _ = tckpt.restore(d, 4, {"beta": 0}, device="cpu")
    assert tree["beta"].tolist() == [4.0, 4.0, 4.0]
    assert tckpt.latest_step(str(tmp_path / "absent")) is None
