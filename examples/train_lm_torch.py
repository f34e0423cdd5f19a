"""End-to-end LM training on the PyTorch port, the twin of
``examples/train_lm.py``: a ~100M-parameter LM through the port's train
step, AdamW, the deterministic data stream, atomic checkpoints and
resume.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 30
    PYTHONPATH=src python examples/train_lm_torch.py --tiny --device cpu

It runs on the card unless ``--device cpu``. This example is one
process on one device, so ``--mesh`` takes a shape of ones; a wider mesh
raises, naming ``torchrun``. A sharded run is the entry point under
``torchrun``, one process per rank:
``torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch yi-9b
--tiny --mesh 2x2 [--device cpu]``. Checkpoints are in the reference's
layout, so a run resumes from either package's, and from any mesh's.
"""

import argparse
import os
import tempfile
import time

from repro_torch.checkpoint import latest_step, restore, save
from repro_torch.configs.common import dense_lm
from repro_torch.convert import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.core.device import resolve_device
from repro_torch.data import SyntheticLM, to_device
from repro_torch.optim import adamw
from repro_torch.train import steps as ST


def lm_100m(seq_vocab=32000):
    """~103M params: 12L, d=640, 10 heads, d_ff=2560, tied embeddings."""
    return dense_lm("lm-100m", n_layers=12, d_model=640, n_heads=10,
                    n_kv_heads=10, d_head=64, d_ff=2560, vocab=seq_vocab)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tiny", action="store_true",
                    help="4L/d256 variant for smoke runs")
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dshape = tuple(int(x) for x in args.mesh.split("x"))
    ST.check_mesh(dshape)
    device = resolve_device(args.device)

    if args.tiny:
        cfg = dense_lm("lm-tiny", n_layers=4, d_model=256, n_heads=4,
                       n_kv_heads=4, d_head=64, d_ff=1024, vocab=8000)
    else:
        cfg = lm_100m()
    tc = ST.TrainConfig(opt=adamw.OptConfig(
        lr=3e-4, warmup_steps=20, total_steps=max(args.steps, 100)))

    state, _ = ST.init_state(0, cfg, tc, device=device)
    nparams = state.params.n_params()
    print(f"model {cfg.name}: {nparams/1e6:.1f}M params, mesh {dshape}")

    src = SyntheticLM(vocab=cfg.vocab, seq=args.seq, global_batch=args.batch)
    step_fn = ST.make_train_step(cfg, tc)

    start = 0
    last = latest_step(args.ckpt_dir)
    if last is not None:
        print(f"resuming from checkpoint step {last}")
        tree, _ = restore(args.ckpt_dir, last,
                          train_state_to_reference(state), device="cpu")
        state = train_state_from_reference(tree, cfg, device=device)
        start = last

    t_tokens = 0
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        batch = to_device(src.host_batch(i), device)
        state, metrics = step_fn(state, batch)
        t_tokens += args.batch * args.seq
        if i % 5 == 0 or i == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {i:4d}  loss {float(metrics['loss']):7.4f}"
                  f"  lr {float(metrics['lr']):.2e}"
                  f"  {t_tokens/max(dt,1e-9):,.0f} tok/s")
        if (i + 1) % args.ckpt_every == 0 or i == args.steps - 1:
            save(args.ckpt_dir, i + 1, train_state_to_reference(state))
    print("done; checkpoints in", args.ckpt_dir)


if __name__ == "__main__":
    main()
