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
from repro_torch.models import model as M
from repro_torch.models import pad_caches
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
DATA_MESHES = {2: ((2, 1),), 4: ((2, 2), (4, 1))}
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
    ``arch`` (fresh copies), zero moments, step 0."""
    pre = arch + "|"
    model = M.holding(TC.get_tiny(arch), {
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
    each arch in each mode on the model-only meshes, in f32 and bf16 and
    the first-step β₁ = 0 run (bf16) on the data-split meshes, and the
    MoE routes on the data-split meshes."""
    out = {}
    for shape in MODEL_MESHES[world]:
        mesh = mesh_of(shape)
        for arch in ARCHS:
            for mode in MODES:
                r = train(inp, arch, mode, mesh)
                out.update({f"{arch}|{shape}|{mode}|{k}": v
                            for k, v in r.items() if k != "params"})
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


JOBS = {"train": compute_train, "ckpt": compute_ckpt,
        "collectives": compute_collectives}


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
