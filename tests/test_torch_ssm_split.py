"""Mamba2 and mLSTM heads over the "model" axis, and the recurrent caches
in the reference's layouts, on the CPU over gloo: a world of 2 ((1, 2),
and a (1, 1) mesh of its rank 0) and a world of 4 ((1, 4) and (2, 2))
spawned once for the module (tests/torch_lm_shard_worker.py,
``job="ssm"``), each case held against the same function on one device
in this process (one thread, as each rank), and the reference's own
sharded xlstm steps and zamba2 and xlstm serve runs in a subprocess per
arch (tests/torch_lm_shard_reference.py, part ``"ssm"``, 4 forced host
devices). Inputs are seeded with numpy; parameters are the port's seeded
tiny models for the mixers and ``"zamba2-odd"``, and the reference's
``init_params(PRNGKey(0))`` for everything held to the reference and for
the whole-model runs.

* the mixers of tiny zamba2-1.2b (Mamba2: 8 heads, split on every mesh)
  and tiny xlstm-350m (mLSTM: 2 heads, split on (1, 2) and (2, 2), whole
  on (1, 4) although ``w_if`` is cut there; sLSTM: whole everywhere)
  over 40 positions in chunks of 16, each leaf as the sharded steps hand
  it to the rank (``steps.leaf_plans``: its block, its pieces or the
  whole): forward and every gradient;
* prefill and decode through the steps on the cut recurrent caches, in
  f32 and bf16: tiny zamba2 (prefill 24: its shared attention caches
  cut over positions, 27: whole; its ``ssm`` cut over heads, ``conv``
  over channels), tiny xlstm (mLSTM ``h`` over d_qk, the sLSTM states
  over d) and ``"zamba2-odd"`` (3 Mamba2 heads: the mixer whole, its
  ``conv`` cache cut over 128 channels), decoding to 32; zamba2's and
  xlstm's on (1, 4) also against the reference's own sharded
  ``make_prefill_step`` and ``make_decode_step``, its caches in
  ``cache_init``'s layouts;
* the collectives of a split train step and of a serve run by purpose;
* tiny xlstm-350m's f32 train step (3 steps at lr 5e-3 on ``SyntheticLM``
  batches of 4 × 32) on (1, 2), (2, 2) and (1, 4), against the port's
  one-device step and against the reference's own sharded step on the
  same mesh;
* tiny zamba2's and xlstm's f32 first-step gradient (β₁ = 0: the first
  moment) on (1, 2), (1, 4) and (2, 2) against the one-device step's;
* a mesh with one "model" rank, (1, 1): tiny zamba2's and xlstm's first
  step (β₁ = 0) in f32 and bf16, bit for bit the one-device step.

Limits: the mixers' f32 values and gradients within 1e-5 of the
one-device function's largest magnitude (the split changes only the
order of f32 sums), and so the whole models' f32 first-step gradients
(this CPU: 3.6e-6 at most); decode within ``W.DECODE_TOL``
(``chip_smoke.LM_DECODE_TOL``: 1e-3 of max|logits| in f32, 5e-2 in
bf16) of the one-device steps and of the reference's sharded steps, in
bf16 beyond the two packages' one-device difference (see
:func:`test_decode_against_the_reference`). The recurrent model
amplifies another order of f32 sums, so the xlstm steps are held to the
reference's own noise: against the port's
one-device step within twice the reference's own sharding noise, its
update distance ‖p − p₁‖ / ‖p₁ − p₀‖ between its step on the mesh and
on (1, 1) (this CPU: 0.0109 on (1, 2), 0.0106 on (2, 2), 0.0159 on (1,
4); the port's split moved 0.0032, 0.0032 and 0.0014), the losses
within 1e-6 relative plus twice the reference's own loss move; against
the reference's own step on the same mesh within twice its one-rounding
move (``XLSTM_F32_YARD``, as tests/test_torch_lm_shard.py holds zamba2),
since the two packages' one-device steps already lie 0.0194 apart (the
port's mesh steps lay 0.0257, 0.0255 and 0.0058 from the reference's),
the losses to rtol 1e-5.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

import torch_lm_shard_worker as W
from repro_torch.models import model as M

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = [(1, 2), (1, 4), (2, 2)]
F32_TOL = 1e-5
REF_TIMEOUT_S = 400
# the mixers split on each model axis: tiny Mamba2's 8 heads divide 2 and
# 4, tiny mLSTM's 2 heads divide 2 only, the sLSTM never splits
SPLITS = {"mamba2": (2, 4), "mlstm": (2,), "slstm": ()}
PARTIAL = {"mamba2": ["a_log", "conv_w", "d_skip", "dt_bias", "w_in"],
           "mlstm": ["f_bias", "w_if", "w_up"], "slstm": []}
PIECES = {"mamba2": ["conv_w", "w_in"], "mlstm": ["w_if", "w_up"],
          "slstm": []}
REGION = {"mamba2": "mamba", "mlstm": "mlstm"}
# tests/test_torch_lm_hybrid_train.py: the reference's own f32 3-step
# update of tiny xlstm-350m moves by this when its initial parameters
# move by one f32 rounding
XLSTM_F32_YARD = 1.7e-2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{shape: rank 0's results, "ranks": {shape: every rank's}, "one":
    the one-device cases, "bits": the one-device first steps, "ref":
    {arch: the reference's runs}, "p0": its initial xlstm parameters as
    a vector}."""
    workdir = str(tmp_path_factory.mktemp("ssm"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"), HERE]))
    refs = {a: subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_lm_shard_reference.py"),
         os.path.join(workdir, f"ref_{a}.npz"),
         os.path.join(workdir, f"init_{a}.npz"), a, "ssm"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for a in W.SSM_DECODE}
    deadline = time.monotonic() + REF_TIMEOUT_S
    init = {}
    for a, proc in refs.items():
        path = os.path.join(workdir, f"init_{a}.npz")
        while not os.path.exists(path):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError(proc.communicate()[0][-3000:])
            time.sleep(0.2)
        with np.load(path) as f:
            init[a] = dict(f)
    inp = {f"{a}|{k}": v for a in init for k, v in init[a].items()}
    np.savez(os.path.join(workdir, "inputs.npz"), **inp)
    started = [W.start_world(w, workdir, "ssm") for w in (2, 4)]
    with W.one_thread():
        one = W.ssm_cases(inp)
        bits = W.ssm_bits(inp)
    worlds = {w: W.join_world(s) for w, s in zip((2, 4), started)}
    out = {"one": one, "bits": bits, "ranks": {}, "ref": {},
           "p0": np.concatenate([v.reshape(-1)
                                 for v in init[W.SSM_TRAIN].values()]),
           "world2": worlds[2]}
    for a, proc in refs.items():
        log, _ = proc.communicate(timeout=REF_TIMEOUT_S)
        assert proc.returncode == 0, log[-3000:]
        with np.load(os.path.join(workdir, f"ref_{a}.npz")) as f:
            out["ref"][a] = dict(f)
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


@pytest.mark.parametrize("kind", list(W.SSM_MIXERS))
@pytest.mark.parametrize("shape", SHAPES)
def test_mixer_split_against_one_device(runs, shape, kind):
    """Forward, x's gradient and every leaf's gradient against the
    one-device mixer; the plans' partial and pieces leaves where the
    heads split (none where the mixer computes whole), and its region's
    sums and the norm's summed squares among the collectives."""
    split = shape[1] in SPLITS[kind]
    want = _fields(runs["one"], f"mixer|{kind}|")
    for r in runs["ranks"][shape]:
        got = _fields(r, f"mixer|{kind}|")
        assert list(got["partial"]) == (PARTIAL[kind] if split else [])
        assert list(got["pieces"]) == (PIECES[kind] if split else [])
        tags = set(got["tags"])
        assert tags == ({REGION[kind], "norm_ss"} if split else set()), tags
        worst = max(_close(got[k], want[k], f"{kind} {k}") for k in want
                    if k in ("out", "d_in") or k.startswith("g|"))
    print(f"{kind} on {shape} ({'split' if split else 'whole'}): worst "
          f"{worst:.3g} of the scale")


@pytest.mark.parametrize("shape,kind", [(s, k) for s in SHAPES
                                        for k in ("mamba2", "mlstm")
                                        if s[1] in SPLITS[k]])
def test_partial_leaves_are_each_ranks_part(runs, shape, kind):
    """Where the heads split, each model rank's gradient of a partial
    leaf (its pieces, or a per-head leaf replicated over "model") is its
    part: none holds the whole gradient's values, and the sum over
    "model" of the parts, placed back, is the one-device gradient (held
    in the test above)."""
    for leaf in PARTIAL[kind]:
        whole = runs["one"][f"mixer|{kind}|g|{leaf}"]
        for r in runs["ranks"][shape][:shape[1]]:
            part = r[f"mixer|{kind}|raw|{leaf}"]
            if part.shape == whole.shape:
                assert np.abs(part - whole).max() > 1e-3 * np.abs(
                    whole).max(), (kind, shape, leaf)
            else:                               # pieces: fewer columns
                assert part.shape[-1] < whole.shape[-1], (leaf, part.shape)


# the compute leaves' widths on a model axis of 2 and of 4 (tiny Mamba2:
# d_inner 128, 8 heads, B and C of 16; tiny mLSTM: d_inner 128, 2 heads)
WIDTHS = {("mamba2", 2): {"w_in": (64, 164), "conv_w": (4, 96),
                          "norm_scale": (64,), "w_out": (64, 64),
                          "a_log": (8,)},
          ("mamba2", 4): {"w_in": (64, 98), "conv_w": (4, 64),
                          "norm_scale": (32,), "w_out": (32, 64)},
          ("mlstm", 2): {"w_up": (64, 192), "w_if": (128, 2),
                         "wq": (128, 1, 32), "w_down": (64, 64),
                         "f_bias": (2,)},
          ("mlstm", 4): {"w_up": (64, 256), "w_if": (128, 4),
                         "wq": (128, 2, 32), "norm_scale": (128,)}}


@pytest.mark.parametrize("kind", ["mamba2", "mlstm"])
@pytest.mark.parametrize("shape", SHAPES)
def test_compute_leaves_are_the_ranks_pieces_and_blocks(runs, shape, kind):
    """Mamba2's ``w_in`` holds the rank's z, x and dt columns and every B
    and C column, ``conv_w`` its x channels and B and C; mLSTM's
    ``w_up`` the whole main half and its gate columns, ``w_if`` its i and
    f columns; where mLSTM computes whole, its leaves are whole."""
    got = runs[shape]
    for leaf, want in WIDTHS[kind, shape[1]].items():
        assert tuple(got[f"mixer|{kind}|shape|{leaf}"]) == want, leaf


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("serve", W.SSM_SERVES)
@pytest.mark.parametrize("shape", SHAPES)
def test_decode_on_the_cut_recurrent_caches(runs, shape, serve, mode):
    """Prefill then decode through the split steps, the recurrent caches
    in the reference's layouts, against the one-device steps: each
    rank's rows of the logits."""
    arch, pre = serve
    key = f"serve|{arch}|{mode}|{pre}"
    for r in runs["ranks"][shape]:
        got = r[key]
        rows = got.shape[0]
        lo = int(r["data_index"]) * rows
        want = runs["one"][key][lo:lo + rows]
        err = float(np.abs(got - want).max() / np.abs(want).max())
        print(f"{arch} {mode} {shape} prefill {pre}: {err:.3g} of "
              f"max|logits|")
        assert err <= W.DECODE_TOL[mode], (arch, mode, shape, pre, err)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("serve", [s for s in W.SSM_SERVES
                                   if s[0] in W.SSM_DECODE])
def test_decode_against_the_reference(runs, serve, mode):
    """Prefill then decode on ``W.REF_SERVE_MESH`` from the reference's
    initial parameters, the recurrent caches in the reference's layouts:
    each rank's logits against the reference's own sharded
    ``make_prefill_step`` and ``make_decode_step`` on the same mesh, its
    caches in ``cache_init``'s layouts, within ``W.DECODE_TOL`` of
    max|logits|. In bf16 the two packages' one-device logits already
    differ (each (row, token)'s largest difference, up to 0.0455 of
    max|logits| for zamba2 on this CPU), and the reference's own (1, 4)
    serve lies 0.027–0.029 (zamba2) and 0.056 (xlstm) from its (1, 1)
    serve: there each (row, token) is
    held within ``W.DECODE_TOL`` beyond that (row, token)'s one-device
    difference, so the limit bounds what the split adds."""
    arch, pre = serve
    ref = runs["ref"][arch]
    want = ref[f"{W.REF_SERVE_MESH}|serve|{mode}|{pre}|{W.TP_SMAX}"]
    scale = np.abs(want).max()
    base, own = np.zeros(want.shape[:2]), ""
    if mode == "bf16":
        one = ref[f"(1, 1)|serve|bf16|{pre}|{W.TP_SMAX}"]
        base = np.abs(runs["one"][f"serve|{arch}|{mode}|{pre}"]
                      - one).max(-1)
        own = (f"; the reference's own {W.REF_SERVE_MESH} against (1, 1): "
               f"{np.abs(want - one).max() / np.abs(want).max():.3g}")
    for r in runs["ranks"][W.REF_SERVE_MESH]:
        got = r[f"serve|{arch}|{mode}|{pre}"]
        rows = got.shape[0]
        lo = int(r["data_index"]) * rows
        err = np.abs(got - want[lo:lo + rows]).max(-1) / scale
        beyond = float((err - base[lo:lo + rows] / scale).max())
        print(f"{arch} {mode} {W.REF_SERVE_MESH} prefill {pre}: "
              f"{err.max():.3g} of max|logits| from the reference's, "
              f"{beyond:.3g} beyond the one-device difference "
              f"({base.max() / scale:.3g}){own}")
        assert beyond <= W.DECODE_TOL[mode], (arch, mode, pre, beyond)


@pytest.mark.parametrize("arch", W.SSM_BITS)
@pytest.mark.parametrize("shape", SHAPES)
def test_f32_first_step_gradient_against_one_device(runs, shape, arch):
    """The whole model's f32 first-step gradient (β₁ = 0: the first
    moment, gathered whole) on ``shape`` within 1e-5 of the one-device
    gradient's largest magnitude, as each module's: the split changes
    the order of f32 sums and nothing else, so the recurrent models'
    larger distance after 3 steps is that rounding amplified by the
    steps."""
    want = runs["one"][f"grad|{arch}"]
    worst = max(_close(r[f"grad|{arch}"], want, f"{arch} gradient")
                for r in runs["ranks"][shape])
    print(f"{arch} {shape} f32 first-step gradient: {worst:.3g} of the "
          f"scale")


@pytest.mark.parametrize("shape", SHAPES)
def test_collectives_of_split_steps(runs, shape):
    """One bf16 train step of tiny zamba2 and xlstm by purpose: the
    Mamba2 region's sums and the norms' summed squares (and mLSTM's
    where its heads split); a serve run moves its recurrent states
    between the compute's and the cache's layouts (``state``)."""
    r = runs[shape]
    for arch, region in (("zamba2-1.2b", "mamba"), ("xlstm-350m", "mlstm")):
        tags = {k: tuple(v) for k, v in _fields(r, f"tags|{arch}|").items()}
        print(f"{arch} {shape}: {tags}")
        split = arch == "zamba2-1.2b" or shape[1] in SPLITS["mlstm"]
        for tag in ("gather", "grad") + ((region, "norm_ss") if split
                                         else ()):
            assert tags.get(tag, (0, 0))[0] > 0, (arch, shape, tag)
        assert (region in tags) == split
        assert "state" in set(r[f"serve_tags|{arch}"]), arch


def _dist(a, b, p0) -> float:
    """‖a − b‖ / ‖b − p₀‖: a's distance from b in units of b's update."""
    return float(np.linalg.norm(a - b) / np.linalg.norm(b - p0))


@pytest.mark.parametrize("shape", SHAPES)
def test_xlstm_step_against_one_device_and_the_reference(runs, shape):
    """Tiny xlstm's f32 steps on ``shape``: against the port's one-device
    step within twice the reference's own distance between its step on
    the mesh and on (1, 1), the losses within 1e-6 relative plus twice
    the reference's own loss move; against the reference's own step on
    the mesh within twice ``XLSTM_F32_YARD`` (the port's one-device step
    already lies near it from the reference's one-device step), the
    losses to rtol 1e-5, no entry further than 2·lr."""
    ref, p0 = runs["ref"][W.SSM_TRAIN], runs["p0"]
    got = _fields(runs[shape], "train|")
    for r in runs["ranks"][shape][1:]:   # every rank holds the same state
        np.testing.assert_array_equal(r["train|params"], got["params"])
    one = _fields(runs["one"], "train|")
    r1, rm = ref["(1, 1)|f32|params"], ref[f"{shape}|f32|params"]
    noise = _dist(rm, r1, p0)
    moved = float(np.abs(ref[f"{shape}|f32|losses"]
                         / ref["(1, 1)|f32|losses"] - 1).max())
    d_one = _dist(got["params"], one["params"], p0)
    d_ref = _dist(got["params"], rm, p0)
    rel_one = float(np.abs(got["losses"] / one["losses"] - 1).max())
    print(f"xlstm {shape} f32: update {d_one:.3g} from one device, "
          f"{d_ref:.3g} from the reference's {shape} step (the one-device "
          f"steps {_dist(one['params'], r1, p0):.3g} apart); the "
          f"reference's own {shape} against (1, 1): {noise:.3g}; losses "
          f"{rel_one:.3g} from one device (the reference's own move "
          f"{moved:.3g})")
    assert d_one <= 2 * noise and rel_one <= 1e-6 + 2 * moved
    assert d_ref <= 2 * XLSTM_F32_YARD
    np.testing.assert_allclose(got["losses"], ref[f"{shape}|f32|losses"],
                               rtol=1e-5)
    assert np.abs(got["params"] - rm).max() <= 2 * W.LR


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("arch", W.SSM_BITS)
def test_a_model_axis_of_one_rank_is_the_one_device_step(runs, arch, mode):
    """A (1, 1) mesh (rank 0 of the world of 2) computes every block
    whole: the first step's parameters and first moment (β₁ = 0: the
    gradient) bit for bit the one-device step's."""
    key = f"bits|{arch}|{mode}"
    assert str(runs["world2"][0][key]) == str(runs["bits"][key])
