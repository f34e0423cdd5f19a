"""The "model" axis's split regions (``repro_torch.pshard.enter`` …
``leave``) module by module, on the CPU over gloo: a world of 2 ((1, 2))
and a world of 4 ((1, 4) and (2, 2)) spawned once for the module
(tests/torch_lm_shard_worker.py, ``job="tp"``), each case held against
the same function on one device in this process (one thread, as each
rank). Inputs are seeded with numpy; parameters are the port's seeded
tiny models.

* attention, block 0 of tiny yi-9b (8 heads, 2 kv: kv cut on (1, 2),
  replicated on (1, 4), where each rank's 2 query heads read one kv
  head), tiny gemma3-4b (``qk_norm``, a window of 16) and tiny
  codeqwen1.5-7b (``qkv_bias``), over 40 positions in tiles of 16;
* the dense FFN of each kind (swiglu, geglu, relu2, gelu);
* the vocab-parallel embedding lookup, chunked loss and last logits,
  tied (yi-9b) and untied (nemotron-4-340b);
* the gradients of leaves replicated over "model" but read inside a
  region (the kv projections of replicated kv heads, ``qnorm``/
  ``knorm``, kv biases): each rank's is a part, their sum the whole;
* prefill and decode through the steps on both cache layouts: tiny
  yi-9b's caches cut over the sequence, and a dense LM with 16 kv heads
  (``kv16``) whose caches cut their heads; prefill of 24 positions (a
  cut cache) and 27 (a whole one, re-cut by ``steps.pad_caches``);
* error-feedback top-k, which ranks whole leaves, on shards;
* the collectives of one split train step by kind and by purpose.

Limits: f32 values and gradients within 1e-5 of the one-device
function's largest magnitude (the split changes only the order of f32
sums); decode within ``W.DECODE_TOL``, ``chip_smoke.LM_DECODE_TOL`` (1e-3 of
max|logits| in f32, 5e-2 in bf16). tests/test_torch_lm_shard.py holds
the same prefill and decode on (1, 4) against the reference's sharded
steps.
"""

import os

import numpy as np
import pytest

import torch_lm_shard_worker as W
from repro_torch import pshard
from repro_torch.launch.mesh import mesh_axes
from repro_torch.models import model as M
from repro_torch.train import steps as ST

SHAPES = [(1, 2), (1, 4), (2, 2)]
F32_TOL = 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{shape: rank 0's results, "ranks": {shape: every rank's}, "one":
    the one-device cases}."""
    workdir = str(tmp_path_factory.mktemp("tp"))
    np.savez(os.path.join(workdir, "inputs.npz"))      # the job reads none
    started = [W.start_world(w, workdir, "tp") for w in (2, 4)]
    with W.one_thread():
        one = W.tp_cases()
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


def _close(got, want, what: str) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= F32_TOL, (what, err)
    return err


def _case(runs, shape, prefix: str):
    got = {k[len(prefix):]: v for k, v in runs[shape].items()
           if k.startswith(prefix)}
    want = {k[len(prefix):]: v for k, v in runs["one"].items()
            if k.startswith(prefix)}
    assert got and set(want) <= set(got)
    return got, want


def _held(got, want, what: str) -> None:
    worst = max(_close(got[k], want[k], f"{what} {k}") for k in want
                if not k.startswith("partial"))
    print(f"{what}: {len(want)} fields, worst {worst:.3g} of the scale")


@pytest.mark.parametrize("arch", W.TP_ATTN)
@pytest.mark.parametrize("shape", SHAPES)
def test_attention_split_against_one_device(runs, shape, arch):
    got, want = _case(runs, shape, f"attn|{arch}|")
    _held(got, want, f"{arch} attention on {shape}")


@pytest.mark.parametrize("kind", W.TP_FFN)
@pytest.mark.parametrize("shape", SHAPES)
def test_ffn_split_against_one_device(runs, shape, kind):
    got, want = _case(runs, shape, f"ffn|{kind}|")
    assert {"g|w_in", "g|w_out"} <= set(want)
    _held(got, want, f"{kind} FFN on {shape}")


@pytest.mark.parametrize("arch", W.TP_VOCAB)
@pytest.mark.parametrize("shape", SHAPES)
def test_vocab_parallel_embedding_head_and_loss(runs, shape, arch):
    got, want = _case(runs, shape, f"vocab|{arch}|")
    assert ("g|lm_head" in want) != W.tp_config(arch).tie_embeddings
    _held(got, want, f"{arch} vocab on {shape}")


# the partial leaves of each tiny attention on each mesh: yi-9b's kv
# heads (2) are cut on (1, 2) and replicated on (1, 4)
PARTIAL = {("yi-9b", 2): [], ("yi-9b", 4): ["wk", "wv"],
           ("gemma3-4b", 2): ["knorm", "qnorm"],
           ("gemma3-4b", 4): ["knorm", "qnorm", "wk", "wv"],
           ("codeqwen1.5-7b", 2): [], ("codeqwen1.5-7b", 4): []}


@pytest.mark.parametrize("shape", SHAPES)
def test_replicated_leaves_read_inside_a_region_sum_their_parts(runs,
                                                                 shape):
    """The plan names the leaves whose gradient is a part on each rank;
    no rank's part is the whole gradient, and the sum over "model" is
    (held to the one-device gradient by the attention test)."""
    for arch in W.TP_ATTN:
        got = runs[shape][f"attn|{arch}|partial"].tolist()
        assert got == PARTIAL[arch, shape[1]], (arch, shape, got)
        for leaf in got:
            whole = runs["one"][f"attn|{arch}|g|{leaf}"]
            parts = [r[f"attn|{arch}|raw|{leaf}"]
                     for r in runs["ranks"][shape]]
            for part in parts:
                assert np.abs(part - whole).max() > 1e-3 * np.abs(
                    whole).max(), (arch, shape, leaf)
            model = parts[:shape[1]]          # data row 0's model ranks
            _close(np.sum(model, axis=0), whole, f"{arch} {leaf} sum")


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("arch", W.TP_DECODE)
@pytest.mark.parametrize("shape", SHAPES)
def test_decode_on_both_cache_layouts(runs, shape, arch, mode):
    """Prefill and decode through the split steps against the one-device
    steps: each rank's rows of the batch."""
    for pre in W.TP_PREFILLS:
        for r in runs["ranks"][shape]:
            got = r[f"serve|{arch}|{mode}|{pre}"]
            rows = got.shape[0]
            lo = int(r["data_index"]) * rows
            want = runs["one"][f"serve|{arch}|{mode}|{pre}"][lo:lo + rows]
            err = float(np.abs(got - want).max() / np.abs(want).max())
            print(f"{arch} {mode} {shape} prefill {pre}: {err:.3g} of "
                  f"max|logits|")
            assert err <= W.DECODE_TOL[mode], (arch, mode, shape, pre, err)


@pytest.mark.parametrize("shape", SHAPES)
def test_topk_error_feedback_on_shards(runs, shape):
    """Top-k ranks whole leaves (``adamw.transform`` gathers the clipped
    shards and the err buffer, keeps the rank's blocks): 3 f32 steps of
    tiny yi-9b at a keep-fraction of 0.3 against one device, by (b)'s
    update distance, and the bf16 err buffer within one bf16 rounding
    (2⁻⁸) of its norm."""
    p0 = np.concatenate([p.detach().reshape(-1).numpy() for p in M.LM(
        W.tp_config("yi-9b"), seed=0, device="cpu").parameters()])
    got, want = runs[shape], runs["one"]
    d = float(np.linalg.norm(got["topk|params"] - want["topk|params"])
              / np.linalg.norm(want["topk|params"] - p0))
    e = float(np.linalg.norm(got["topk|err"] - want["topk|err"])
              / np.linalg.norm(want["topk|err"]))
    print(f"top-k on {shape}: update distance {d:.3g}, err {e:.3g}")
    assert d <= 1e-4 and e <= 2 ** -8


def test_cache_layouts_cut_heads_or_sequence_as_the_reference():
    """:func:`steps.cache_layouts` on (16, 16): yi-9b's 4 kv heads cut
    the sequence over "model", 16 kv heads cut themselves; MLA's latent
    caches cut their sequence, the reference's ``P("batch", "tensor",
    None)``; a sequence 16 does not divide stays whole."""
    mesh = pshard.MeshShape(mesh_axes((16, 16)), (16, 16))
    for arch, want in (("yi-9b", ("data", None, "model", None)),
                       ("kv16", ("data", "model", None, None))):
        lay = ST.cache_layouts(W.tp_config(arch), mesh, 256, 32768)
        assert tuple(lay[0][0]["b0"]["k"].spec) == want, arch
    odd = ST.cache_layouts(W.tp_config("yi-9b"), mesh, 256, 27)
    assert tuple(odd[0][0]["b0"]["k"].spec) == ("data", None, None, None)
    from repro_torch import configs as TC
    mla = ST.cache_layouts(TC.get_tiny("deepseek-v2-lite-16b"), mesh, 256,
                           64)
    for n in ("c", "kpe"):
        assert tuple(mla[0][0]["b0"][n].spec) == ("data", "model", None)
    odd = ST.cache_layouts(TC.get_tiny("deepseek-v2-lite-16b"), mesh, 256,
                           27)
    assert tuple(odd[0][0]["b0"]["c"].spec) == ("data", None, None)


# the recurrent caches' resolved specs on (16, 16), the reference's
# cache specs (Mamba2 ``ssm`` P("batch", "tensor", None, None), ``conv``
# P("batch", None, "tensor"), mLSTM ``h`` P("batch", None, "tensor",
# None), sLSTM P("batch", "tensor")) with "tensor" over "model" where 16
# divides the dim: (arch, tiny, block) → {cache: spec}
RECURRENT_CACHES = {
    ("zamba2-1.2b", False, "b0"): {"ssm": ("data", "model", None, None),
                                   "conv": ("data", None, "model")},
    ("zamba2-1.2b", False, "b6"): {"k": ("data", "model", None, None)},
    ("xlstm-350m", False, "b0"): {"h": ("data", None, "model", None)},
    ("xlstm-350m", False, "b7"): {n: ("data", "model")
                                  for n in M.SLSTM_STATE},
    # tiny zamba2's 8 heads do not divide 16, its 160 conv channels do
    ("zamba2-1.2b", True, "b0"): {"ssm": ("data", None, None, None),
                                  "conv": ("data", None, "model")},
}


@pytest.mark.parametrize("arch,tiny,block", list(RECURRENT_CACHES))
def test_cache_layouts_cut_recurrent_states_as_the_reference(arch, tiny,
                                                             block):
    """:func:`steps.cache_layouts` on (16, 16) resolves the recurrent
    caches' specs too (Mamba2's heads and conv channels, mLSTM's d_qk,
    sLSTM's d), each the rank's block of the whole cache."""
    from repro_torch import configs as TC
    mesh = pshard.MeshShape(mesh_axes((16, 16)), (16, 16))
    cfg = TC.get_tiny(arch) if tiny else TC.get_config(arch)
    lay = ST.cache_layouts(cfg, mesh, 256, 32768)[0][0][block]
    for n, want in RECURRENT_CACHES[arch, tiny, block].items():
        assert tuple(lay[n].spec) == want, (n, lay[n].spec)
        cut = [d for d, e in enumerate(want) if e == "model"]
        assert all(lay[n].local_shape[d] * 16 == lay[n].shape[d]
                   for d in cut), n


def test_leaf_plans_on_the_production_mesh():
    """yi-9b on (16, 16): a leaf cut over "model" stays the rank's block
    (gathered over "data" alone), the replicated kv projections are
    partial; deepseek-v2-lite's MLA heads and MoE experts stay the rank's
    blocks too (its ``w_dkv``, ``kv_norm`` and router partial), and no
    leaf of deepseek-v2-lite or moonshot-v1-16b-a3b is gathered over
    "model"."""
    from repro_torch import configs as TC
    mesh = pshard.MeshShape(mesh_axes((16, 16)), (16, 16))
    for arch in ("yi-9b", "deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"):
        cfg = TC.get_config(arch)
        model = M.LM(cfg, device="meta")
        plans = ST.leaf_plans(cfg, pshard.resolve_tree(
            mesh, model.specs(), dict(model.named_parameters())))
        if arch == "yi-9b":
            p = "segments.0.0.b0."
            assert plans[p + "mixer.wq"] == ST.LeafPlan(("data",), False)
            assert plans[p + "mixer.wk"] == ST.LeafPlan(("data",), True)
            assert plans[p + "ffn.w_out"] == ST.LeafPlan(("data",), False)
            assert plans["embed"] == ST.LeafPlan(("data",), False)
            assert not plans[p + "norm1.scale"].partial
        else:
            assert not [k for k, pl in plans.items()
                        if pshard.MODEL_AXIS in pl.gathered], arch
        if arch == "deepseek-v2-lite-16b":
            moe, mla = "segments.1.0.b0.ffn.", "segments.0.0.b0.mixer."
            for leaf in ("w_in", "w_gate", "w_out", "shared.w_in"):
                assert plans[moe + leaf] == ST.LeafPlan(("data",), False)
            assert plans[moe + "router"] == ST.LeafPlan(("data",), True)
            for leaf in ("wq", "wo"):
                assert plans[mla + leaf] == ST.LeafPlan(("data",), False)
            for leaf in ("w_uk", "w_uv"):        # "lora" is replicated
                assert plans[mla + leaf] == ST.LeafPlan((), False)
            assert plans[mla + "w_dkv"] == ST.LeafPlan(("data",), True)
            assert plans[mla + "kv_norm"] == ST.LeafPlan((), True)
            assert plans["segments.0.0.b0.ffn.w_in"] == ST.LeafPlan(
                ("data",), False)


def test_mamba2_plans_on_the_production_mesh():
    """zamba2-1.2b on (16, 16): a Mamba2 rank computes its 4 of 64 heads.
    It reads ``w_in`` as pieces, 644 of 8 384 columns (its z, x and dt
    columns and every B and C column), and ``conv_w`` as 384 of 4 224
    channels, each gathered whole and its gradient summed over "model";
    ``norm_scale`` and ``w_out`` are its blocks (gathered over "data"
    alone); ``a_log``, ``dt_bias`` and ``d_skip`` are partial; the
    shared block's heads are cut as yi-9b's."""
    import torch
    from repro_torch import configs as TC
    mesh = pshard.MeshShape(mesh_axes((16, 16)), (16, 16))
    cfg = TC.get_config("zamba2-1.2b")
    model = M.LM(cfg, device="meta")
    named = dict(model.named_parameters())
    plans = ST.leaf_plans(cfg, pshard.resolve_tree(mesh, model.specs(),
                                                   named))
    for i in range(6):                       # every Mamba2 block alike
        p = f"segments.0.0.b{i}.mixer."
        for leaf, axes, width in (("w_in", ("data", "model"), 644),
                                  ("conv_w", ("model",), 384)):
            pl = plans[p + leaf]
            assert (pl.gathered, pl.partial) == (axes, True), leaf
            got = pl.pieces.take(torch.empty(named[p + leaf].shape,
                                             device="meta"), 15, 16)
            assert got.shape[-1] == width, leaf
        assert plans[p + "norm_scale"] == ST.LeafPlan((), False)
        assert plans[p + "w_out"] == ST.LeafPlan(("data",), False)
        for leaf in ("a_log", "dt_bias", "d_skip"):
            assert plans[p + leaf] == ST.LeafPlan((), True), leaf
    assert plans["shared.mixer.wq"] == ST.LeafPlan(("data",), False)
    assert not [k for k, pl in plans.items() if pshard.MODEL_AXIS in
                pl.gathered and pl.pieces is None], "a leaf gathered whole"


def test_xlstm_plans_on_the_production_mesh_are_unchanged():
    """xlstm-350m on (16, 16): its 4 heads do not divide 16, so every
    mLSTM and sLSTM mixer computes whole and its leaves are gathered over
    every axis that cuts them, partial nowhere; the other leaves (the
    embedding, the norms) are gathered over all but "model"."""
    from repro_torch import configs as TC
    mesh = pshard.MeshShape(mesh_axes((16, 16)), (16, 16))
    cfg = TC.get_config("xlstm-350m")
    model = M.LM(cfg, device="meta")
    layouts = pshard.resolve_tree(mesh, model.specs(),
                                  dict(model.named_parameters()))
    want = {k: ST.LeafPlan(lay.axes if ".mixer." in k else tuple(
        a for a in lay.axes if a != pshard.MODEL_AXIS), False)
        for k, lay in layouts.items()}
    assert ST.leaf_plans(cfg, layouts) == want
    assert want["segments.0.0.b0.mixer.w_up"].gathered == ("data", "model")


@pytest.mark.parametrize("shape", SHAPES)
def test_collectives_of_a_split_train_step(runs, shape):
    """One bf16 train step of tiny yi-9b: the region sums (forward and
    backward), the vocab-parallel lookup and loss (a MAX and a SUM a
    chunk), the gradients' reductions (reduce-scatters where "data"
    cuts a leaf and the batch) and the clip's sums, by purpose."""
    r = runs[shape]
    kinds = {k[len("kinds|"):]: tuple(v) for k, v in r.items()
             if k.startswith("kinds|")}
    tags = {k[len("tags|"):]: tuple(v) for k, v in r.items()
            if k.startswith("tags|")}
    print(f"{shape}: {kinds}; {tags}")
    for tag in ("region", "embed", "vocab_max", "vocab_sum", "grad",
                "norm", "gather", "loss"):
        assert tags.get(tag, (0, 0))[0] > 0, (shape, tag)
    assert kinds["reduce_scatter"][0] > 0       # a data axis of 1 too
    assert sum(c for c, _ in kinds.values()) == sum(
        c for c, _ in tags.values())
