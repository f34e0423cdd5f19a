"""One rank of a gloo world for the sharded LM tests
(tests/test_torch_lm_shard.py, tests/test_torch_lm_shard_ckpt.py).

``start_world(world, workdir, job)`` spawns ``world`` processes; each
joins a gloo process group through a FileStore under ``workdir``, runs
``JOBS[job]`` on ``workdir/inputs.npz`` and writes its own results to
``workdir/<job>_<world>_r<rank>.npz``; :func:`join_world` waits (with a
timeout, so a hung rendezvous fails its test) and loads every rank's.

Every run starts from the parameters in ``inputs.npz`` (``"<arch>|<port
name>"``: the reference's ``init_params(PRNGKey(0))``, carried into port
names) and takes ``SyntheticLM`` batches of ``BATCH`` sequences of
``SEQ``; :func:`train` also runs in the test process, unsharded, for the
one-device arms. No JAX here: the reference runs in the test process or
in its own subprocess (tests/torch_lm_shard_reference.py).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch import configs as TC
from repro_torch import pshard
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.convert import (shardings_to_reference,
                                 train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.data import SyntheticLM, device_batch, to_device
from repro_torch.launch.mesh import make_mesh, make_mesh_for, mesh_axes
from repro_torch.models import layers as L
from repro_torch.models import mla as MLA
from repro_torch.models import model as M
from repro_torch.models import pad_caches
from repro_torch.models import ssm as S
from repro_torch.optim import adamw
from repro_torch.runtime import ElasticConfig, SimulatedFailure, run_elastic
from repro_torch.train import steps as ST

JOIN_TIMEOUT_S = 240
ARCHS = ("yi-9b", "deepseek-v2-lite-16b", "zamba2-1.2b")
MOE_ARCH = "deepseek-v2-lite-16b"
LR = 5e-3
STEPS = 3
SEQ = 32
BATCH = 4
MODES = {"f32": dict(compute_dtype="float32", fp32_grads=True),
         "bf16": {}, "bf16_accum2": dict(accum_steps=2)}
# β₁ = 0 and no clip: AdamW's first moment after one step is the gradient
FIRST_STEP = dict(betas=(0.0, 0.95), grad_clip=1e9)
MODEL_MESHES = {2: ((1, 2),), 4: ((1, 4),)}
# prefill and decode held to the reference's on this mesh
REF_SERVE_MESH = (1, 4)
DATA_MESHES = {2: ((2, 1),), 4: ((2, 2), (4, 1))}
# a second MoE model (GQA attention), trained in f32 on this mesh alone
F32_ONLY = {"moonshot-v1-16b-a3b": (1, 4)}
DECODE = 4           # (e): decode steps after a prefill of SEQ - DECODE
CKPT_ARCH = "deepseek-v2-lite-16b"
CKPT_STEP = 2        # (d): the (2, 2) run checkpoints here
ELASTIC_STEPS = 5
ELASTIC_FAIL = 3


def mesh_of(shape) -> object:
    """A ``("data", "model")`` (or longer) mesh of ``shape`` over ranks
    [0, size) of the running world."""
    return make_mesh(pshard.MeshShape(mesh_axes(shape), tuple(shape)),
                     "cpu")


def train_config(mode: str, **opt) -> ST.TrainConfig:
    return ST.TrainConfig(opt=adamw.OptConfig(
        lr=LR, warmup_steps=2, total_steps=60, **opt), **MODES[mode])


def initial_state(inp, arch: str, tc: ST.TrainConfig) -> ST.TrainState:
    """The one-device state holding ``inputs.npz``'s parameters of
    ``arch`` (:func:`tp_config`; fresh copies), zero moments, step 0."""
    pre = arch + "|"
    model = M.holding(tp_config(arch), {
        k[len(pre):]: torch.from_numpy(np.array(v))
        for k, v in inp.items() if k.startswith(pre)})
    return ST.TrainState(model, adamw.init(tc.opt, dict(
        model.named_parameters())), torch.zeros((), dtype=torch.int32))


def flat(tree: dict) -> np.ndarray:
    """A {name: tensor} dict as one float32 vector, in its order."""
    return np.concatenate([t.detach().float().reshape(-1).numpy()
                           for t in tree.values()])


def digest(tree: dict) -> np.ndarray:
    """sha256 of every leaf's bytes, in order (bit-for-bit checks)."""
    h = hashlib.sha256()
    for t in tree.values():
        h.update(t.detach().contiguous().view(torch.uint8).numpy().tobytes())
    return np.array(h.hexdigest())


def whole(tree: dict, layouts) -> dict:
    """Every rank's shards of a {name: tensor} tree → the whole leaves."""
    if layouts is None:
        return tree
    return {k: pshard.gather(t.detach(), layouts[k]) for k, t in tree.items()}


def train(inp, arch: str, mode: str, mesh=None, steps: int = STEPS,
          **opt) -> dict:
    """``steps`` train steps of ``arch`` in ``mode`` from ``inp``'s
    parameters, on ``mesh`` (None: one device): losses, the whole
    parameters as a vector, the digests of the parameters and moments,
    and (``opt``: the first-step β₁ = 0 run) the first moment."""
    cfg = TC.get_tiny(arch)
    tc = train_config(mode, **opt)
    state = initial_state(inp, arch, tc)
    src = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH)
    sh = None
    if mesh is None:
        step = ST.make_train_step(cfg, tc)
        batch = lambda i: to_device(src.host_batch(i), "cpu")  # noqa: E731
    else:
        state, sh = ST.shard_state(state, mesh)
        step = ST.make_train_step(cfg, tc, mesh, sh, ST.batch_shardings(
            mesh, cfg, "train", src.host_batch(0)))
        batch = lambda i: device_batch(  # noqa: E731
            mesh, src.host_batch(i), tc.accum_steps)
    losses = []
    for i in range(steps):
        state, metrics = step(state, batch(i))
        losses.append(float(metrics["loss"]))
    params = whole(dict(state.params.named_parameters()),
                   None if sh is None else sh.params)
    m = whole(state.opt.m, None if sh is None else sh.opt.m)
    v = whole(state.opt.v, None if sh is None else sh.opt.v)
    out = {"losses": np.array(losses), "params": flat(params),
           "params_digest": digest(params), "m_digest": digest(m),
           "v_digest": digest(v)}
    if opt:
        out["m"] = flat(m)
    return out


def routes(inp, mesh, shape) -> dict:
    """The kept set and the experts of every MoE call of a f32 forward of
    batch 0 with ``inp``'s deepseek parameters, as this rank sees its own
    tokens: ``whole``, routed over the whole batch (the step's batch
    context), and ``local``, routed over the rank's tokens alone."""
    cfg = TC.get_tiny(MOE_ARCH)
    tc = train_config("f32")
    state, sh = ST.shard_state(initial_state(inp, MOE_ARCH, tc), mesh)
    src = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH)
    batch = device_batch(mesh, src.host_batch(0))
    spec = ST._batch_spec(mesh, ST.batch_shardings(mesh, cfg, "train",
                                                   src.host_batch(0)))
    tree = L.tree_from_named(whole(dict(state.params.named_parameters()),
                                   sh.params))
    seen, orig = [], L.moe_route

    def spy(params, mspec, x):
        r = orig(params, mspec, x)
        with pshard.batch_context(mesh, pshard.P(None)):
            alone = orig(params, mspec, x)
        seen.append((r, alone))
        return r

    def mine(r):
        rows = slice(r.lo, r.lo + r.tokens)
        k = r.topi.shape[-1]
        return (r.topi.reshape(-1, k)[rows].numpy(),
                r.keep.reshape(-1, k)[rows].numpy())

    with mock.patch.object(L, "moe_route", spy), torch.no_grad(), \
            pshard.batch_context(mesh, spec):
        M.forward_loss(tree, cfg, batch, compute_dtype=torch.float32)
    out = {}
    for i, (r, alone) in enumerate(seen):
        for tag, route in (("whole", r), ("local", alone)):
            topi, keep = mine(route)
            out[f"routes_{shape}_{tag}_{i}_topi"] = topi
            out[f"routes_{shape}_{tag}_{i}_keep"] = keep
    return out


def compute_train(inp, world: int) -> dict:
    """Every arm of tests/test_torch_lm_shard.py in a world of ``world``:
    each arch in each mode and the first-step β₁ = 0 run (bf16) on the
    model-only meshes, with the serve runs of ``REF_DECODE`` from
    ``inp``'s parameters on ``REF_SERVE_MESH``; in f32 and bf16 and the
    first-step run on the data-split meshes, the MoE routes on the
    data-split meshes, and each of ``F32_ONLY`` in f32 on its mesh."""
    out = {}
    for arch, shape in F32_ONLY.items():
        if shape[0] * shape[1] == world:
            r = train(inp, arch, "f32", mesh_of(shape))
            out.update({f"{arch}|{shape}|f32|{k}": v for k, v in r.items()})
    for shape in MODEL_MESHES[world]:
        mesh = mesh_of(shape)
        for arch in ARCHS:
            for mode in MODES:
                r = train(inp, arch, mode, mesh)
                out.update({f"{arch}|{shape}|{mode}|{k}": v
                            for k, v in r.items()})
            r = train(inp, arch, "bf16", mesh, steps=1, **FIRST_STEP)
            out[f"{arch}|{shape}|first|m"] = r["m"]
        if shape == REF_SERVE_MESH:
            for arch, serves in REF_DECODE.items():
                for mode in ("f32", "bf16"):
                    for pre, smax in serves:
                        out[f"{arch}|{shape}|serve|{mode}|{pre}|{smax}"] = \
                            tp_serve(arch, mode, pre, mesh, inp, smax)
    for shape in DATA_MESHES[world]:
        mesh = mesh_of(shape)
        for arch in ARCHS:
            for mode in ("f32", "bf16"):
                r = train(inp, arch, mode, mesh)
                out.update({f"{arch}|{shape}|{mode}|{k}": v
                            for k, v in r.items()})
            r = train(inp, arch, "bf16", mesh, steps=1, **FIRST_STEP)
            out[f"{arch}|{shape}|first|m"] = r["m"]
        out.update(routes(inp, mesh, shape))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_lm_shard_ckpt.py: checkpoints, elastic, serving steps
# ---------------------------------------------------------------------------

def _sharded_run(inp, mesh, tc, steps: int, ckpt_dir: str | None = None,
                 at: int = -1):
    """``steps`` steps of CKPT_ARCH on ``mesh`` from ``inp``; with
    ``ckpt_dir`` a sharded checkpoint after step ``at``. Returns the
    state, its shardings and the losses."""
    cfg = TC.get_tiny(CKPT_ARCH)
    src = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH)
    state, sh = ST.shard_state(initial_state(inp, CKPT_ARCH, tc), mesh)
    step = ST.make_train_step(cfg, tc, mesh, sh, ST.batch_shardings(
        mesh, cfg, "train", src.host_batch(0)))
    losses, saved = [], None
    for i in range(steps):
        state, m = step(state, device_batch(mesh, src.host_batch(i)))
        losses.append(float(m["loss"]))
        if i + 1 == at:
            ckpt.save(ckpt_dir, at, train_state_to_reference(state),
                      shardings=shardings_to_reference(sh))
            saved = flat(whole(dict(state.params.named_parameters()),
                               sh.params))
    return state, sh, losses, saved


def resume(ckpt_dir: str, mesh, tc, start: int, steps: int) -> dict:
    """Restore CKPT_ARCH's checkpoint of step ``start`` on ``mesh`` (None:
    one device) and take the steps up to ``steps``: the restored and the
    final whole parameters, and the losses."""
    cfg = TC.get_tiny(CKPT_ARCH)
    src = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH)
    like, sh = ST.init_state(0, cfg, tc, mesh, device="cpu")
    tree, _ = ckpt.restore(ckpt_dir, start, train_state_to_reference(like),
                           device="cpu", shardings=None if sh is None
                           else shardings_to_reference(sh))
    state = train_state_from_reference(tree, cfg, device="cpu")
    lay = None if sh is None else sh.params
    restored = flat(whole(dict(state.params.named_parameters()), lay))
    if mesh is None:
        step = ST.make_train_step(cfg, tc)
        batch = lambda i: to_device(src.host_batch(i), "cpu")  # noqa: E731
    else:
        step = ST.make_train_step(cfg, tc, mesh, sh, ST.batch_shardings(
            mesh, cfg, "train", src.host_batch(0)))
        batch = lambda i: device_batch(mesh, src.host_batch(i))  # noqa
    losses = []
    for i in range(start, steps):
        state, m = step(state, batch(i))
        losses.append(float(m["loss"]))
    params = whole(dict(state.params.named_parameters()), lay)
    return {"restored": restored, "params": flat(params),
            "digest": digest(params), "losses": np.array(losses)}


def elastic(inp, ckpt_dir: str) -> dict:
    """``run_elastic`` over the world of 4: (2, 2) = ``make_mesh_for(4,
    2)`` until a ``SimulatedFailure`` on every rank at ELASTIC_FAIL, then
    ``make_mesh_for(2, 2)`` = (1, 2); ranks 2 and 3 leave."""
    cfg = TC.get_tiny(CKPT_ARCH)
    tc = train_config("f32")
    src = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH)
    failed, box = [], {}

    def make(attempt):
        return make_mesh_for(4 if attempt == 0 else 2, 2, "cpu")

    def init_fn(mesh):
        box["state"], box["sh"] = ST.shard_state(
            initial_state(inp, CKPT_ARCH, tc), mesh)
        return box["state"]

    def restore_fn(mesh, step):
        like, sh = ST.init_state(0, cfg, tc, mesh)
        tree, _ = ckpt.restore(ckpt_dir, step, train_state_to_reference(
            like), device="cpu", shardings=shardings_to_reference(sh))
        box["sh"] = sh
        return train_state_from_reference(tree, cfg, device="cpu")

    def step_fn(mesh, state, i):
        if i == ELASTIC_FAIL and not failed:
            failed.append(i)
            raise SimulatedFailure(f"lost at step {i}")
        key = (id(mesh), id(box["sh"]))
        if box.get("key") != key:
            box["key"] = key
            box["step"] = ST.make_train_step(
                cfg, tc, mesh, box["sh"], ST.batch_shardings(
                    mesh, cfg, "train", src.host_batch(0)))
        box["state"] = box["step"](state, device_batch(
            mesh, src.host_batch(i)))[0]
        return box["state"]

    rep = run_elastic(
        ElasticConfig(ckpt_dir=ckpt_dir, ckpt_every=2),
        make_mesh=make, init_fn=init_fn, restore_fn=restore_fn,
        step_fn=step_fn, save_fn=lambda s, i: train_state_to_reference(s),
        total_steps=ELASTIC_STEPS,
        shardings_fn=lambda mesh: shardings_to_reference(box["sh"]))
    out = {"elastic_restarts": np.array(rep.restarts),
           "elastic_left": np.array(rep.left),
           "elastic_meshes": np.array([list(s) for s in rep.mesh_history]),
           "elastic_steps": np.array(rep.steps_done)}
    if not rep.left:
        out["elastic_params"] = flat(whole(dict(
            box["state"].params.named_parameters()), box["sh"].params))
    return out


def serve(inp, mesh, arch: str) -> dict:
    """Prefill of SEQ - DECODE tokens then DECODE decode steps of ``arch``
    (f32) on ``mesh`` (None: one device), every rank on its rows of a
    batch of BATCH: the rank's logits (BATCH_local, DECODE + 1, V)."""
    cfg = TC.get_tiny(arch)
    tc = ST.TrainConfig(compute_dtype="float32")
    state = initial_state(inp, arch, tc)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (BATCH, SEQ),
                                             dtype=np.int32)
    pre = SEQ - DECODE
    if mesh is None:
        prefill, decode = (ST.make_prefill_step(cfg, tc),
                           ST.make_decode_step(cfg, tc))
        rows = torch.from_numpy(toks)
    else:
        state, sh = ST.shard_state(state, mesh)
        bsh = ST.batch_shardings(mesh, cfg, "serve", {"tokens": toks})
        prefill = ST.make_prefill_step(cfg, tc, mesh, sh.params, bsh)
        decode = ST.make_decode_step(cfg, tc, mesh, sh.params, None, bsh)
        rows = device_batch(mesh, {"tokens": toks})["tokens"]
    last, caches = prefill(state.params, {"tokens": rows[:, :pre]})
    caches = pad_caches(caches, SEQ)
    outs = [last[:, 0]]
    for t in range(pre, SEQ):
        lg, caches = decode(state.params, rows[:, t:t + 1], caches, t)
        outs.append(lg[:, 0])
    return torch.stack(outs, 1).numpy()


def compute_ckpt(inp, world: int) -> dict:
    """Every sharded arm of tests/test_torch_lm_shard_ckpt.py in a world
    of 4: the (2, 2) run with its checkpoint at CKPT_STEP, the (1, 2)
    resume on ranks 0 and 1, the elastic run, and prefill + decode on a
    (2, 1) mesh of ranks 0 and 1."""
    tc = train_config("f32")
    d = os.environ["LM_SHARD_CKPT"]
    out = {}
    state, sh, losses, saved = _sharded_run(
        inp, mesh_of((2, 2)), tc, STEPS, os.path.join(d, "run"), CKPT_STEP)
    out["full_losses"] = np.array(losses)
    out["full_saved"] = saved
    out["full_params"] = flat(whole(dict(state.params.named_parameters()),
                                    sh.params))
    pair = mesh_of((1, 2))
    if pair.get_coordinate() is not None:
        out.update({f"resume12_{k}": v for k, v in resume(
            os.path.join(d, "run"), pair, tc, CKPT_STEP, STEPS).items()})
    col = mesh_of((2, 1))
    if col.get_coordinate() is not None:
        for arch in ARCHS:
            out[f"serve_{arch}"] = serve(inp, col, arch)
    out.update(elastic(inp, os.path.join(d, "elastic")))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_dryrun.py: the collectives of one real sharded step
# ---------------------------------------------------------------------------

COLLECTIVE_ARCHS = ("yi-9b", "deepseek-v2-lite-16b")


def compute_collectives(inp, world: int) -> dict:
    """One bf16 train step of each of ``COLLECTIVE_ARCHS`` on a (2, 2)
    mesh: its collectives by kind, (calls, bytes this rank contributed)
    as ``pshard.collective_counts`` counts them."""
    out = {}
    mesh = mesh_of((2, 2))
    for arch in COLLECTIVE_ARCHS:
        cfg = TC.get_tiny(arch)
        tc = ST.TrainConfig()
        state, sh = ST.init_state(0, cfg, tc, mesh)
        src = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH)
        step = ST.make_train_step(cfg, tc, mesh, sh, ST.batch_shardings(
            mesh, cfg, "train", src.host_batch(0)))
        batch = device_batch(mesh, src.host_batch(0))
        pshard.reset_collectives()
        step(state, batch)
        for kind, (calls, nbytes) in pshard.collective_counts().items():
            out[f"{arch}|{kind}"] = np.array([calls, nbytes])
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_tp.py: the "model" axis's split regions, module by module
# ---------------------------------------------------------------------------

TP_MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
TP_ATTN = ("yi-9b", "gemma3-4b", "codeqwen1.5-7b")
TP_FFN = ("swiglu", "geglu", "relu2", "gelu")
TP_VOCAB = ("yi-9b", "nemotron-4-340b")          # tied, untied head
TP_DECODE = ("yi-9b", "kv16")
TP_SEQ = 40
TP_CHUNK = 16
TP_PREFILLS = (24, 27)       # a cache cut over the sequence, and a whole one
TP_SMAX = 32
# the serve runs held to the reference's sharded steps on REF_SERVE_MESH,
# {arch: ((prefill, smax), ...)}: tiny deepseek-v2-lite-16b's latent
# caches are cut over positions where 4 divide smax, so its (24, 33)
# decodes on a whole cache
REF_DECODE = {a: tuple((p, TP_SMAX) for p in TP_PREFILLS)
              for a in TP_DECODE + ("deepseek-v2-lite-16b",)}
REF_DECODE["deepseek-v2-lite-16b"] += ((TP_PREFILLS[0], TP_SMAX + 1),)
# the MoE model's bf16 top-k choices have near ties (tiny routers give
# near-uniform probabilities) that the two packages' bf16 roundings
# already resolve otherwise on one device; its bf16 serve runs also run
# on one device in both, to tell such a choice from the split's error
ROUTE_TIES = ("deepseek-v2-lite-16b",)
# decode's limits, chip_smoke.LM_DECODE_TOL: of max|logits|
DECODE_TOL = {"f32": 1e-3, "bf16": 5e-2}
MODEL = (pshard.MODEL_AXIS,)
# ``dense_lm``'s arguments of "kv16" (either package's)
KV16 = dict(n_layers=2, d_model=64, n_heads=16, n_kv_heads=16, d_head=4,
            d_ff=128, vocab=256)


def tp_config(arch: str) -> M.ArchConfig:
    """A tiny config: ``TC.get_tiny(arch)``, or ``"kv16"``: a dense LM with
    16 kv heads, whose attention caches cut their heads over "model", or
    ``"zamba2-odd"`` (``SSM_ODD``): a zamba2 whose 3 Mamba2 heads divide
    no model axis while its conv channels (128) do."""
    if arch == "kv16":
        from repro_torch.configs.common import dense_lm
        return dense_lm("kv16-tiny", **KV16)
    if arch == "zamba2-odd":
        from repro_torch.configs.zamba2_1_2b import _build
        return _build("zamba2-odd", **SSM_ODD)
    return TC.get_tiny(arch)


def serve_tokens(vocab: int, width: int = TP_SMAX) -> np.ndarray:
    """The (BATCH, width) tokens that prefill and decode read."""
    return np.random.default_rng(7).integers(0, vocab, (BATCH, width),
                                             dtype=np.int32)


def _rng_tensor(seed: int, shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def module_case(named: dict, specs: dict, fn, inputs: tuple, mesh=None,
                partial=(), rows: bool = False) -> dict:
    """``fn(params, *inputs)`` and the gradients of ``Σ out·w`` (w seeded)
    with respect to ``inputs[0]`` and every leaf of ``named`` (whole f32
    leaves): on one device, or (``mesh``) with each leaf the rank's block
    along "model" (``specs`` resolved on the mesh) under the model
    context, the ``partial`` leaves' gradients summed over "model" and
    every gradient gathered whole. With ``rows`` the rank takes its rows
    of ``inputs[0]`` and of w (dim 0 cut over "data", under the batch
    context) and the leaves' gradients are summed over "data"; "out" and
    "d_in" are then the rank's rows. Returns {"out", "d_in", "g|<name>",
    and on a mesh "raw|<name>": a partial leaf's gradient before its sum
    over "model"}."""
    x, w = inputs[0].clone(), None
    lays = None
    if mesh is None:
        params = {k: v.clone().requires_grad_() for k, v in named.items()}
        ctx = contextlib.nullcontext()
    else:
        lays = {k: lay.only(MODEL) for k, lay in pshard.resolve_tree(
            mesh, specs, named).items()}
        params = {k: pshard.cut(v, lays[k]).requires_grad_()
                  for k, v in named.items()}
        ctx = pshard.model_context(mesh)
        if rows:                 # fn keeps x's shape: w is cut as x
            w = _rng_tensor(99, tuple(x.shape))
            n = x.shape[0] // pshard.axis_sizes(mesh)["data"]
            at = slice(pshard.coordinate(mesh)["data"] * n, None)
            x, w = x[at][:n], w[at][:n]
            ctx = contextlib.ExitStack()
            ctx.enter_context(pshard.model_context(mesh))
            ctx.enter_context(pshard.batch_context(
                mesh, pshard.batch_spec(mesh, 1)))
    x.requires_grad_()
    with ctx:
        out = fn(L.tree_from_named(params), x, *inputs[1:])
        if w is None:
            w = _rng_tensor(99, tuple(out.shape))
        torch.sum(out * w).backward()
    res = {"out": out.detach().numpy(), "d_in": x.grad.numpy()}
    for k, p in params.items():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        if lays is not None:
            if rows:
                pshard.all_reduce(g, mesh, ("data",))
            if k in partial:
                res[f"raw|{k}"] = g.numpy().copy()
                pshard.all_reduce(g, mesh, (pshard.MODEL_AXIS,))
            g = pshard.gather(g, lays[k])
        res[f"g|{k}"] = g.numpy()
    return res


def _block_leaves(cfg: M.ArchConfig, prefix: str) -> tuple[dict, dict]:
    """The seeded whole leaves and logical specs under ``prefix`` of
    ``cfg``'s LM, keyed by their names below it."""
    model = M.LM(cfg, seed=0, device="cpu")
    specs = model.specs()
    named = {k[len(prefix):]: p.detach().clone()
             for k, p in model.named_parameters() if k.startswith(prefix)}
    return named, {k[len(prefix):]: v for k, v in specs.items()
                   if k.startswith(prefix)}


def tp_attention(arch: str, mesh=None) -> dict:
    """Block 0's attention of the tiny ``arch`` (and its partial leaves
    by :func:`repro_torch.train.steps.leaf_plans` on ``mesh``)."""
    cfg = tp_config(arch)
    blk = cfg.segments[0].blocks[0]
    prefix = "segments.0.0.b0.mixer."
    named, specs = _block_leaves(cfg, prefix)
    partial = ()
    if mesh is not None:
        model = M.LM(cfg, device="meta")
        plans = ST.leaf_plans(cfg, pshard.resolve_tree(
            mesh, model.specs(), dict(model.named_parameters())))
        partial = tuple(k[len(prefix):] for k, pl in plans.items()
                        if k.startswith(prefix) and pl.partial)
    x = _rng_tensor(1, (2, TP_SEQ, cfg.d_model))
    pos = torch.arange(TP_SEQ).expand(2, TP_SEQ)

    def fn(params, x):
        return L.attn_forward(params, blk.attn, x, pos, q_chunk=TP_CHUNK,
                              k_chunk=TP_CHUNK)

    out = module_case(named, specs, fn, (x,), mesh, partial)
    out["partial"] = np.array(sorted(partial))
    return out


def tp_ffn(kind: str, mesh=None) -> dict:
    spec = L.FfnSpec(d_model=64, d_ff=128, kind=kind)
    gen = torch.Generator().manual_seed(3)
    named = {k: p.detach().clone()
             for k, p in L.Ffn(spec, gen).named_parameters()}
    x = _rng_tensor(2, (2, TP_SEQ, 64))
    return module_case(named, {k: L.Ffn.SPECS[k] for k in named},
                       lambda p, x: L.ffn_forward(p, spec, x), (x,), mesh)


def tp_vocab(arch: str, mesh=None) -> dict:
    """The embedding lookup, the chunked loss (chunks of ``TP_CHUNK``) and
    the last logits of the tiny ``arch``, whose embedding and head are
    the case's leaves."""
    import dataclasses
    cfg = dataclasses.replace(tp_config(arch), loss_chunk=TP_CHUNK)
    model = M.LM(cfg, seed=0, device="cpu")
    keys = ("embed", "lm_head")
    named = {k: p.detach().clone() for k, p in model.named_parameters()
             if k in keys}
    specs = {k: v for k, v in model.specs().items() if k in keys}
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, TP_SEQ)))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, TP_SEQ)))
    mask = torch.from_numpy(rng.random((2, TP_SEQ)) < 0.8)
    x = _rng_tensor(4, (2, TP_SEQ, cfg.d_model))

    def fn(params, x):
        h = M.embed_tokens(params, cfg, tokens, torch.float32) + x
        loss = M.chunked_xent(params, cfg, h, labels, mask)
        return loss * 1e3 + 0 * torch.sum(h[:1, :1, :1])

    out = module_case(named, specs, fn, (x,), mesh)
    tree = L.tree_from_named(named if mesh is None else {
        k: pshard.cut(v, lay.only(MODEL)) for (k, v), lay in zip(
            named.items(), pshard.resolve_tree(mesh, specs,
                                               named).values())})
    with torch.no_grad(), (contextlib.nullcontext() if mesh is None
                           else pshard.model_context(mesh)):
        out["logits"] = M.logits_for(tree, cfg, x[:, -1:]).numpy()
    return out


def tp_serve(arch: str, mode: str, pre: int, mesh=None, inp=None,
             smax: int = TP_SMAX) -> dict:
    """Prefill of ``pre`` tokens then decode to ``smax`` of ``tp_config
    (arch)`` in ``mode`` (f32 or bf16) through the steps, a batch of
    BATCH rows, from the seed-0 parameters (or ``inp``'s): the rank's
    logits (rows, smax − pre + 1, V)."""
    cfg = tp_config(arch)
    tc = (ST.TrainConfig(compute_dtype="float32") if mode == "f32"
          else ST.TrainConfig())
    toks = serve_tokens(cfg.vocab, smax)
    if mesh is None:
        state = (ST.init_state(0, cfg, tc, device="cpu")[0] if inp is None
                 else initial_state(inp, arch, tc))
        prefill, decode_of = ST.make_prefill_step(cfg, tc), (
            lambda csh: ST.make_decode_step(cfg, tc))
        rows = torch.from_numpy(toks)
    else:
        if inp is None:
            state, sh = ST.init_state(0, cfg, tc, mesh)
        else:
            state, sh = ST.shard_state(initial_state(inp, arch, tc), mesh)
        bsh = ST.batch_shardings(mesh, cfg, "serve", {"tokens": toks})
        prefill = ST.make_prefill_step(cfg, tc, mesh, sh.params, bsh)
        decode_of = (lambda csh: ST.make_decode_step(
            cfg, tc, mesh, sh.params, csh, bsh))
        rows = device_batch(mesh, {"tokens": toks})["tokens"]
    last, caches = prefill(state.params, {"tokens": rows[:, :pre]})
    caches, csh = ST.pad_caches(cfg, mesh, caches, BATCH, pre, smax)
    decode = decode_of(csh)
    outs = [last[:, 0]]
    for t in range(pre, smax):
        lg, caches = decode(state.params, rows[:, t:t + 1], caches, t)
        outs.append(lg[:, 0])
    return torch.stack(outs, 1).float().numpy()


def tp_topk(mesh=None) -> dict:
    """``STEPS`` f32 train steps of tiny yi-9b with error-feedback top-k
    (a 0.3 keep-fraction), which ranks whole leaves: the parameters and
    the err buffer after them, whole."""
    cfg = TC.get_tiny("yi-9b")
    tc = ST.TrainConfig(compute_dtype="float32", fp32_grads=True,
                        opt=adamw.OptConfig(lr=LR, warmup_steps=2,
                                            total_steps=60,
                                            topk_compress=0.3))
    state, sh = ST.init_state(0, cfg, tc, mesh, device="cpu")
    src = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH)
    if mesh is None:
        step = ST.make_train_step(cfg, tc)
        batch = lambda i: to_device(src.host_batch(i), "cpu")  # noqa: E731
    else:
        step = ST.make_train_step(cfg, tc, mesh, sh, ST.batch_shardings(
            mesh, cfg, "train", src.host_batch(0)))
        batch = lambda i: device_batch(mesh, src.host_batch(i))  # noqa
    for i in range(STEPS):
        state, _ = step(state, batch(i))
    lay = None if sh is None else sh.params
    return {"params": flat(whole(dict(state.params.named_parameters()),
                                 lay)),
            "err": flat(whole(state.opt.err, lay))}


def tp_cases(mesh=None) -> dict:
    """Every case of tests/test_torch_tp.py on ``mesh`` (None: one
    device), keyed ``<kind>|<case>|<field>``."""
    out = {}
    for a in TP_ATTN:
        out.update({f"attn|{a}|{k}": v
                    for k, v in tp_attention(a, mesh).items()})
    for kind in TP_FFN:
        out.update({f"ffn|{kind}|{k}": v
                    for k, v in tp_ffn(kind, mesh).items()})
    for a in TP_VOCAB:
        out.update({f"vocab|{a}|{k}": v
                    for k, v in tp_vocab(a, mesh).items()})
    for a in TP_DECODE:
        for mode in ("f32", "bf16"):
            for pre in TP_PREFILLS:
                out[f"serve|{a}|{mode}|{pre}"] = tp_serve(a, mode, pre, mesh)
    out.update({f"topk|{k}": v for k, v in tp_topk(mesh).items()})
    return out


def compute_tp(inp, world: int) -> dict:
    """tests/test_torch_tp.py's cases on each mesh of ``TP_MESHES[world]``
    (``"<shape>|..."``), the rank's data index on it, and the collectives
    of one bf16 train step of tiny yi-9b on each."""
    out = {}
    for shape in TP_MESHES[world]:
        mesh = mesh_of(shape)
        out.update({f"{shape}|{k}": v for k, v in tp_cases(mesh).items()})
        out[f"{shape}|data_index"] = np.array(
            pshard.coordinate(mesh)["data"])
        cfg = TC.get_tiny("yi-9b")
        tc = ST.TrainConfig()
        state, sh = ST.init_state(0, cfg, tc, mesh)
        src = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH)
        step = ST.make_train_step(cfg, tc, mesh, sh, ST.batch_shardings(
            mesh, cfg, "train", src.host_batch(0)))
        batch = device_batch(mesh, src.host_batch(0))
        pshard.reset_collectives()
        step(state, batch)
        for table, got in (("kinds", pshard.collective_counts()),
                           ("tags", pshard.collective_tags())):
            for k, (calls, nbytes) in got.items():
                out[f"{shape}|{table}|{k}"] = np.array([calls, nbytes])
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_ep.py: MLA heads and MoE experts over "model"
# ---------------------------------------------------------------------------

EP_ARCH = "deepseek-v2-lite-16b"
# the MoE cases: routed experts (8 divide 2 and 4; 6 divide 2, not 4)
# and shared experts
EP_MOE = {"shared": dict(n_routed=8, n_shared=1),
          "routed": dict(n_routed=8, n_shared=0),
          "six": dict(n_routed=6, n_shared=1)}
# routing groups of 32 tokens: a data rank of (2, 2) holds 40 tokens, so
# a group straddles its two ranks
EP_GROUP = 32
EP_SEQ = 40
EP_PREFILLS = (40, 27)          # a latent cache cut over positions, whole
# (prefill, decode's positions): each cache layout in decode (32 cut, 33
# whole), from a cut and from a whole prefill cache
EP_SERVES = ((24, 32), (27, 32), (24, 33))


def ep_config(kind: str) -> M.ArchConfig:
    """A one-layer MoE LM of ``EP_MOE[kind]`` at the tiny widths (d 64,
    4 heads, experts of 32, top-2), its routing groups of ``EP_GROUP``."""
    import dataclasses
    from repro_torch.configs.common import moe_lm
    cfg = moe_lm(f"ep-{kind}", n_layers=1, d_model=64, n_heads=4,
                 n_kv_heads=4, d_head=16, d_expert=32, top_k=2, vocab=256,
                 **EP_MOE[kind])
    seg = cfg.segments[0]
    blk = dataclasses.replace(seg.blocks[0], moe=dataclasses.replace(
        seg.blocks[0].moe, group_size=EP_GROUP))
    return dataclasses.replace(cfg, segments=(dataclasses.replace(
        seg, blocks=(blk,)),))


def _partials(cfg, prefix: str, mesh) -> tuple:
    """The leaves under ``prefix`` whose plan on ``mesh`` is partial."""
    model = M.LM(cfg, device="meta")
    plans = ST.leaf_plans(cfg, pshard.resolve_tree(
        mesh, model.specs(), dict(model.named_parameters())))
    return tuple(sorted(k[len(prefix):] for k, pl in plans.items()
                        if k.startswith(prefix) and pl.partial))


def ep_moe(kind: str, mesh=None) -> dict:
    """The MoE FFN of ``ep_config(kind)`` on (2, 40, 64) inputs, every
    rank its rows of them (routing over the whole batch), and its
    collectives by purpose."""
    cfg = ep_config(kind)
    prefix = "segments.0.0.b0.ffn."
    named, specs = _block_leaves(cfg, prefix)
    spec = cfg.segments[0].blocks[0].moe
    partial = () if mesh is None else _partials(cfg, prefix, mesh)
    x = _rng_tensor(12, (2, EP_SEQ, cfg.d_model))
    pshard.reset_collectives()
    out = module_case(named, specs, lambda p, x: L.moe_forward(p, spec, x),
                      (x,), mesh, partial, rows=True)
    out["partial"] = np.array(partial)
    out["tags"] = np.array(sorted(pshard.collective_tags()))
    return out


def ep_mla(mesh=None) -> dict:
    """Block 0's MLA of tiny deepseek-v2-lite-16b over ``EP_SEQ`` positions
    in tiles of 16 (forward and every gradient), and prefill's latent
    cache of each of ``EP_PREFILLS`` positions (the rank's block and its
    layout)."""
    cfg = tp_config(EP_ARCH)
    spec = cfg.segments[0].blocks[0].mla
    prefix = "segments.0.0.b0.mixer."
    named, specs = _block_leaves(cfg, prefix)
    partial = () if mesh is None else _partials(cfg, prefix, mesh)
    x = _rng_tensor(13, (2, EP_SEQ, cfg.d_model))
    pos = torch.arange(EP_SEQ).expand(2, EP_SEQ)

    def fn(params, x):
        return MLA.mla_forward(params, spec, x, pos, q_chunk=TP_CHUNK,
                               k_chunk=TP_CHUNK)[0]

    out = module_case(named, specs, fn, (x,), mesh, partial)
    out["partial"] = np.array(partial)
    tree = L.tree_from_named(named if mesh is None else {
        k: pshard.cut(v, lay.only(MODEL)) for (k, v), lay in zip(
            named.items(), pshard.resolve_tree(mesh, specs, named).values())})
    with torch.no_grad(), (contextlib.nullcontext() if mesh is None
                           else pshard.model_context(mesh)):
        for seq in EP_PREFILLS:
            cut = MLA.mla_cache_cut(seq)
            _, (c, kpe) = MLA.mla_forward(tree, spec, x[:, :seq],
                                          pos[:, :seq], q_chunk=TP_CHUNK,
                                          k_chunk=TP_CHUNK, cache=cut)
            out[f"cache{seq}|c"], out[f"cache{seq}|kpe"] = c.numpy(), \
                kpe.numpy()
            out[f"cache{seq}|cut"] = np.array(cut)
    return out


def ep_cases(mesh=None) -> dict:
    """Every case of tests/test_torch_ep.py on ``mesh`` (None: one
    device), keyed ``<kind>|<case>|<field>``."""
    out = {}
    for kind in EP_MOE:
        out.update({f"moe|{kind}|{k}": v
                    for k, v in ep_moe(kind, mesh).items()})
    out.update({f"mla|{k}": v for k, v in ep_mla(mesh).items()})
    for mode in ("f32", "bf16"):
        for pre, smax in EP_SERVES:
            out[f"serve|{mode}|{pre}|{smax}"] = tp_serve(
                EP_ARCH, mode, pre, mesh, smax=smax)
    return out


def compute_ep(inp, world: int) -> dict:
    """tests/test_torch_ep.py's cases on each mesh of ``TP_MESHES[world]``
    (``"<shape>|..."``), the rank's data index on it, and the collectives
    of one bf16 train step of tiny deepseek-v2-lite-16b on each."""
    out = {}
    for shape in TP_MESHES[world]:
        mesh = mesh_of(shape)
        out.update({f"{shape}|{k}": v for k, v in ep_cases(mesh).items()})
        out[f"{shape}|data_index"] = np.array(
            pshard.coordinate(mesh)["data"])
        cfg = TC.get_tiny(EP_ARCH)
        tc = ST.TrainConfig()
        state, sh = ST.init_state(0, cfg, tc, mesh)
        src = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH)
        step = ST.make_train_step(cfg, tc, mesh, sh, ST.batch_shardings(
            mesh, cfg, "train", src.host_batch(0)))
        batch = device_batch(mesh, src.host_batch(0))
        pshard.reset_collectives()
        step(state, batch)
        for k, (calls, nbytes) in pshard.collective_tags().items():
            out[f"{shape}|tags|{k}"] = np.array([calls, nbytes])
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_ssm_split.py: Mamba2 and mLSTM heads over "model"
# ---------------------------------------------------------------------------

SSM_ARCHS = ("zamba2-1.2b", "xlstm-350m")
# the module cases: (arch, block index in segment 0); the scans run in
# chunks of SSM_CHUNK over SSM_SEQ positions
SSM_MIXERS = {"mamba2": ("zamba2-1.2b", 0), "mlstm": ("xlstm-350m", 0),
              "slstm": ("xlstm-350m", 1)}
SSM_SEQ = 40
SSM_CHUNK = 16
# ``_build``'s arguments of "zamba2-odd": d_inner 96, 3 heads of 32,
# conv channels 96 + 2·16
SSM_ODD = dict(d_model=48, n_mamba=3, period=2, n_heads=4, n_kv=4,
               d_head=12, d_ff=96, d_state=16, vocab=256, head_dim=32)
# the serve runs held to the reference's sharded prefill and decode on
# REF_SERVE_MESH, from its initial parameters, {arch: ((prefill, smax),
# ...)}: zamba2's shared attention caches (4 kv heads) are cut over
# positions from 24 and whole from 27
SSM_DECODE = {"zamba2-1.2b": ((24, TP_SMAX), (27, TP_SMAX)),
              "xlstm-350m": ((24, TP_SMAX),)}
# every serve run, (arch, prefill) to TP_SMAX: SSM_DECODE's, and
# "zamba2-odd" from its seed-0 parameters
SSM_SERVES = tuple((a, p) for a, runs in SSM_DECODE.items()
                   for p, _ in runs) + (("zamba2-odd", 24),)
SSM_TRAIN = "xlstm-350m"        # held to the reference's sharded steps here
# a (1, 1) mesh against one device; the f32 first-step gradient on every
# mesh against one device
SSM_BITS = ("zamba2-1.2b", "xlstm-350m")


def ssm_mixer(kind: str, mesh=None) -> dict:
    """The ``kind`` mixer of its tiny arch over (2, SSM_SEQ, d) inputs,
    forward and every gradient, each leaf as the sharded steps hand it
    to the rank (:func:`repro_torch.train.steps.leaf_plans` on ``mesh``:
    its block, its pieces or the whole), on one device without ``mesh``;
    the partial leaves' gradients summed over "model" (placed back first
    where they are pieces; "raw|" before the sum) and every gradient
    whole. Also the compute leaves' shapes, the plans' partial and
    pieces leaves and the collectives by purpose."""
    import dataclasses
    arch, bi = SSM_MIXERS[kind]
    cfg = tp_config(arch)
    blk = cfg.segments[0].blocks[bi]
    spec = {"mamba2": blk.mamba, "mlstm": blk.mlstm, "slstm": blk.slstm}[kind]
    if kind != "slstm":
        spec = dataclasses.replace(spec, chunk=SSM_CHUNK)
    fn = {"mamba2": S.mamba2_forward, "mlstm": S.mlstm_forward,
          "slstm": S.slstm_forward}[kind]
    prefix = f"segments.0.0.b{bi}.mixer."
    named, _ = _block_leaves(cfg, prefix)
    x = _rng_tensor(21, (2, SSM_SEQ, cfg.d_model))
    plans = {}
    if mesh is not None:
        model = M.LM(cfg, device="meta")
        plans = {k[len(prefix):]: pl for k, pl in ST.leaf_plans(
            cfg, pshard.resolve_tree(mesh, model.specs(), dict(
                model.named_parameters()))).items() if k.startswith(prefix)}
        lays = {k[len(prefix):]: lay.only(MODEL) for k, lay in
                pshard.resolve_tree(mesh, model.specs(), dict(
                    model.named_parameters())).items()
                if k.startswith(prefix)}
        at = (pshard.coordinate(mesh)[pshard.MODEL_AXIS],
              pshard.axis_sizes(mesh)[pshard.MODEL_AXIS])
    params = {}
    for k, v in named.items():
        pl = plans.get(k)
        if pl is None or pshard.MODEL_AXIS in pl.gathered:
            t = v.clone() if pl is None or pl.pieces is None \
                else pl.pieces.take(v, *at)
        else:
            t = pshard.cut(v, lays[k])
        params[k] = t.requires_grad_()
    x.requires_grad_()
    pshard.reset_collectives()
    with (contextlib.nullcontext() if mesh is None
          else pshard.model_context(mesh)):
        out = fn(L.tree_from_named(params), spec, x)[0]
        torch.sum(out * _rng_tensor(99, tuple(out.shape))).backward()
    res = {"out": out.detach().numpy(), "d_in": x.grad.numpy(),
           "tags": np.array(sorted(pshard.collective_tags()))}
    for k, p in params.items():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        res[f"shape|{k}"] = np.array(tuple(p.shape))
        pl = plans.get(k)
        if pl is not None and pl.partial:
            res[f"raw|{k}"] = g.numpy().copy()
            if pl.pieces is not None:
                g = pl.pieces.place(g, *at)
            pshard.all_reduce(g, mesh, MODEL)
        elif pl is not None and pshard.MODEL_AXIS not in pl.gathered:
            g = pshard.gather(g, lays[k])
        res[f"g|{k}"] = g.numpy()
    res["partial"] = np.array(sorted(k for k, pl in plans.items()
                                     if pl.partial))
    res["pieces"] = np.array(sorted(k for k, pl in plans.items()
                                    if pl.pieces is not None))
    return res


def ssm_serve_tags(arch: str, mesh) -> np.ndarray:
    """The collectives' purposes of a bf16 prefill of 24 and one decode
    step of ``tp_config(arch)`` on ``mesh``."""
    pshard.reset_collectives()
    tp_serve(arch, "bf16", TP_SMAX - 1, mesh)
    return np.array(sorted(pshard.collective_tags()))


def ssm_cases(inp, mesh=None) -> dict:
    """Every case of tests/test_torch_ssm_split.py on ``mesh`` (None: one
    device), keyed ``<kind>|<case>|<field>``: the mixers, the serve runs
    in f32 and bf16 (``SSM_DECODE``'s from ``inp``'s parameters),
    ``SSM_TRAIN``'s f32 train steps and each of ``SSM_BITS``' f32 first
    step's gradient (β₁ = 0: the first moment) from ``inp``'s
    parameters."""
    out = {}
    for kind in SSM_MIXERS:
        out.update({f"mixer|{kind}|{k}": v
                    for k, v in ssm_mixer(kind, mesh).items()})
    for arch, pre in SSM_SERVES:
        for mode in ("f32", "bf16"):
            out[f"serve|{arch}|{mode}|{pre}"] = tp_serve(
                arch, mode, pre, mesh, inp if arch in SSM_DECODE else None)
    out.update({f"train|{k}": v
                for k, v in train(inp, SSM_TRAIN, "f32", mesh).items()})
    for arch in SSM_BITS:
        out[f"grad|{arch}"] = train(inp, arch, "f32", mesh, steps=1,
                                    **FIRST_STEP)["m"]
    return out


def compute_ssm(inp, world: int) -> dict:
    """tests/test_torch_ssm_split.py's cases on each mesh of
    ``TP_MESHES[world]`` (``"<shape>|..."``), the rank's data index, the
    collectives of one bf16 train step of each of ``SSM_ARCHS`` and of a
    serve run on each; in a world of 2, :func:`ssm_bits` on a (1, 1)
    mesh of rank 0."""
    out = {}
    for shape in TP_MESHES[world]:
        mesh = mesh_of(shape)
        out.update({f"{shape}|{k}": v
                    for k, v in ssm_cases(inp, mesh).items()})
        out[f"{shape}|data_index"] = np.array(
            pshard.coordinate(mesh)["data"])
        for arch in SSM_ARCHS:
            cfg = TC.get_tiny(arch)
            tc = ST.TrainConfig()
            state, sh = ST.init_state(0, cfg, tc, mesh)
            src = SyntheticLM(vocab=cfg.vocab, seq=SEQ, global_batch=BATCH)
            step = ST.make_train_step(cfg, tc, mesh, sh, ST.batch_shardings(
                mesh, cfg, "train", src.host_batch(0)))
            pshard.reset_collectives()
            step(state, device_batch(mesh, src.host_batch(0)))
            for k, (calls, nbytes) in pshard.collective_tags().items():
                out[f"{shape}|tags|{arch}|{k}"] = np.array([calls, nbytes])
            out[f"{shape}|serve_tags|{arch}"] = ssm_serve_tags(arch, mesh)
    if world == 2:
        one = mesh_of((1, 1))
        if one.get_coordinate() is not None:
            out.update(ssm_bits(inp, one))
    return out


def ssm_bits(inp, mesh=None) -> dict:
    """Each of ``SSM_BITS``' first step (β₁ = 0) in f32 and bf16 on
    ``mesh`` (None: one device): the digests of its parameters and first
    moment."""
    out = {}
    for arch in SSM_BITS:
        for mode in ("f32", "bf16"):
            r = train(inp, arch, mode, mesh, steps=1, **FIRST_STEP)
            out[f"bits|{arch}|{mode}"] = np.array(
                f"{r['params_digest']} {r['m_digest']}")
    return out


JOBS = {"train": compute_train, "ckpt": compute_ckpt,
        "collectives": compute_collectives, "tp": compute_tp,
        "ep": compute_ep, "ssm": compute_ssm}


def _run(rank: int, world: int, workdir: str, job: str) -> None:
    torch.set_num_threads(1)
    os.environ["LM_SHARD_CKPT"] = workdir
    store = dist.FileStore(os.path.join(workdir, f"store_{job}_{world}"),
                           world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        with np.load(os.path.join(workdir, "inputs.npz")) as f:
            inp = dict(f)
        out = JOBS[job](inp, world)
        np.savez(os.path.join(workdir, f"{job}_{world}_r{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def start_world(world: int, workdir: str, job: str):
    """Spawn a world running ``JOBS[job]`` without waiting for it."""
    ctx = mp.start_processes(_run, args=(world, workdir, job), nprocs=world,
                             join=False, start_method="spawn")
    return ctx, world, workdir, job


def join_world(started) -> list[dict]:
    """Join a :func:`start_world` world (killed after JOIN_TIMEOUT_S) and
    load every rank's results, in rank order."""
    ctx, world, workdir, job = started
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"world of {world} ranks did not finish in "
                               f"{JOIN_TIMEOUT_S} s")
    out = []
    for r in range(world):
        with np.load(os.path.join(workdir, f"{job}_{world}_r{r}.npz")) as f:
            out.append(dict(f))
    return out


@contextlib.contextmanager
def one_thread():
    """torch on one thread, as each spawned rank (the one-device arms are
    then bit for bit comparable)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
