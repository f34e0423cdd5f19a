"""MLA heads and MoE experts over the "model" axis, module by module, on
the CPU over gloo: a world of 2 ((1, 2)) and a world of 4 ((1, 4) and
(2, 2)) spawned once for the module (tests/torch_lm_shard_worker.py,
``job="ep"``), each case held against the same function on one device in
this process (one thread, as each rank). Inputs are seeded with numpy;
parameters are the port's seeded tiny models.

* MoE (``layers.moe_forward``) of a one-layer LM at the tiny widths (d
  64, experts of 32, top-2) with routing groups of 32 tokens: 8 routed
  experts with a shared expert and without, and 6 with one (6 divide
  2 but not 4: on (1, 4) the rules replicate the experts and every rank
  computes them whole, with no sum over "model"); every rank
  takes its rows of a (2, 40, 64) input, so on (2, 2) a routing group
  straddles the two data ranks; forward and every gradient (the router's
  a part on each rank where the experts are cut);
* MLA (``mla.mla_forward``) of tiny deepseek-v2-lite-16b's block 0 over
  40 positions in tiles of 16 (4 heads; ``w_dkv`` and ``kv_norm``
  partial), and prefill's latent cache of 40 positions (cut over
  "model") and of 27 (whole);
* prefill and decode of tiny deepseek-v2-lite-16b through the steps, in
  f32 and bf16, on both decode cache layouts: 32 positions (cut) from a
  cut and from a whole prefill cache, and 33 (whole);
* the collectives of one split bf16 train step by purpose.

Limits: f32 values and gradients within 1e-5 of the one-device
function's largest magnitude (the split changes only the order of f32
sums), as tests/test_torch_tp.py; decode within ``W.DECODE_TOL``
(``chip_smoke.LM_DECODE_TOL``: 1e-3 of max|logits| in f32, 5e-2 in
bf16). tests/test_torch_lm_shard.py holds the whole deepseek and
moonshot steps against the reference's sharded steps.
"""

import os

import numpy as np
import pytest

import torch_lm_shard_worker as W

SHAPES = [(1, 2), (1, 4), (2, 2)]
F32_TOL = 1e-5
MOE_FIELDS = ("out", "d_in")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{shape: rank 0's results, "ranks": {shape: every rank's}, "one":
    the one-device cases}."""
    workdir = str(tmp_path_factory.mktemp("ep"))
    np.savez(os.path.join(workdir, "inputs.npz"))      # the job reads none
    started = [W.start_world(w, workdir, "ep") for w in (2, 4)]
    with W.one_thread():
        one = W.ep_cases()
    worlds = {w: W.join_world(s) for w, s in zip((2, 4), started)}
    out = {"one": one, "ranks": {}}
    for shape in SHAPES:
        ranks = worlds[shape[0] * shape[1]]
        out["ranks"][shape] = [{k[len(f"{shape}|"):]: v
                                for k, v in r.items()
                                if k.startswith(f"{shape}|")}
                               for r in ranks]
        out[shape] = out["ranks"][shape][0]
    return out


def _fields(res: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


def _close(got, want, what: str) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= F32_TOL, (what, err)
    return err


@pytest.mark.parametrize("kind", list(W.EP_MOE))
@pytest.mark.parametrize("shape", SHAPES)
def test_moe_experts_split_against_one_device(runs, shape, kind):
    """Every rank's rows of the output and of x's gradient, and every
    leaf's whole gradient (summed over "data", the partial ones over
    "model"), against the one-device MoE. The experts are cut where
    their count divides "model" (the "experts" sums run, the router is
    partial); else computed whole (no such sum, no partial leaf)."""
    want = _fields(runs["one"], f"moe|{kind}|")
    split = W.EP_MOE[kind]["n_routed"] % shape[1] == 0
    worst = 0.0
    for r in runs["ranks"][shape]:
        got = _fields(r, f"moe|{kind}|")
        assert list(got["partial"]) == (["router"] if split else [])
        assert ("experts" in got["tags"]) == split, got["tags"]
        assert ("shared" in got["tags"]) == (
            W.EP_MOE[kind]["n_shared"] > 0), got["tags"]
        rows = got["out"].shape[0]
        lo = int(r["data_index"]) * rows
        for k in MOE_FIELDS:
            worst = max(worst, _close(got[k], want[k][lo:lo + rows],
                                      f"{kind} {k}"))
        for k in want:
            if k.startswith("g|"):
                worst = max(worst, _close(got[k], want[k], f"{kind} {k}"))
    print(f"MoE {kind} on {shape} (experts {'cut' if split else 'whole'}):"
          f" worst {worst:.3g} of the scale")


@pytest.mark.parametrize("shape", SHAPES)
def test_moe_router_gradient_is_a_part_on_each_rank(runs, shape):
    """Where the experts are cut, each model rank's router gradient is
    its experts' part (none is the whole), and their sum over "model"
    (data row 0's ranks, summed over "data" already) is the one-device
    gradient."""
    for kind in ("shared", "routed"):
        whole = runs["one"][f"moe|{kind}|g|router"]
        parts = [r[f"moe|{kind}|raw|router"]
                 for r in runs["ranks"][shape][:shape[1]]]
        for part in parts:
            assert np.abs(part - whole).max() > 1e-3 * np.abs(whole).max()
        _close(np.sum(parts, axis=0), whole, f"{kind} router sum")


@pytest.mark.parametrize("shape", SHAPES)
def test_mla_heads_split_against_one_device(runs, shape):
    """Forward and every gradient against one device; ``w_dkv`` and
    ``kv_norm`` are partial, each rank's part no whole gradient, their
    sum the one-device gradient."""
    got, want = _fields(runs[shape], "mla|"), _fields(runs["one"], "mla|")
    assert list(got["partial"]) == ["kv_norm", "w_dkv"]
    worst = max(_close(got[k], want[k], f"MLA {k}") for k in want
                if k == "out" or k == "d_in" or k.startswith("g|"))
    for leaf in got["partial"]:
        parts = [r[f"mla|raw|{leaf}"]
                 for r in runs["ranks"][shape][:shape[1]]]
        for part in parts:
            assert np.abs(part - want[f"g|{leaf}"]).max() > 1e-3 * np.abs(
                want[f"g|{leaf}"]).max()
        _close(np.sum(parts, axis=0), want[f"g|{leaf}"], f"{leaf} sum")
    print(f"MLA on {shape}: worst {worst:.3g} of the scale")


@pytest.mark.parametrize("seq", W.EP_PREFILLS)
@pytest.mark.parametrize("shape", SHAPES)
def test_mla_prefill_cache_in_the_reference_layout(runs, shape, seq):
    """Prefill's latent cache: the rank's block of positions where
    "model" divides them (the reference's ``P("batch", "tensor", None)``),
    else every position; its values the one-device cache's."""
    want_cut = "seq" if seq % shape[1] == 0 else "whole"
    for i, r in enumerate(runs["ranks"][shape]):
        assert str(r[f"mla|cache{seq}|cut"]) == want_cut
        model = i % shape[1]
        for n in ("c", "kpe"):
            got, whole = r[f"mla|cache{seq}|{n}"], runs["one"][
                f"mla|cache{seq}|{n}"]
            if want_cut == "seq":
                width = seq // shape[1]
                whole = whole[:, model * width:(model + 1) * width]
            assert got.shape == whole.shape, (n, got.shape, whole.shape)
            _close(got, whole, f"cache {seq} {n}")


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("serve", W.EP_SERVES)
@pytest.mark.parametrize("shape", SHAPES)
def test_mla_decode_on_both_cache_layouts(runs, shape, serve, mode):
    """Prefill and decode of tiny deepseek-v2-lite-16b through the split
    steps against the one-device steps: each rank's rows."""
    pre, smax = serve
    key = f"serve|{mode}|{pre}|{smax}"
    for r in runs["ranks"][shape]:
        got = r[key]
        rows = got.shape[0]
        lo = int(r["data_index"]) * rows
        want = runs["one"][key][lo:lo + rows]
        err = float(np.abs(got - want).max() / np.abs(want).max())
        print(f"{mode} {shape} prefill {pre}, decode to {smax}: {err:.3g} "
              f"of max|logits|")
        assert err <= W.DECODE_TOL[mode], (mode, shape, serve, err)


@pytest.mark.parametrize("shape", SHAPES)
def test_collectives_of_a_split_moe_mla_step(runs, shape):
    """One bf16 train step of tiny deepseek-v2-lite-16b (4 heads, 8
    experts, a shared expert of 32): MLA's region sums, the routed and
    the shared experts' sums, the dense FFN's, the gradients' reductions
    and the leaves' gathers, by purpose."""
    r = runs[shape]
    tags = {k[len("tags|"):]: tuple(v) for k, v in r.items()
            if k.startswith("tags|")}
    print(f"{shape}: {tags}")
    for tag in ("mla", "experts", "shared", "region", "grad", "gather"):
        assert tags.get(tag, (0, 0))[0] > 0, (shape, tag)
