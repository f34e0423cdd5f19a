"""Group-EDPP structured pruning of a trained LM's FFN neurons on the
PyTorch port, the twin of ``examples/prune_ffn.py``: the bridge between
the paper's technique and the architecture zoo.

Recipe:
  1. train a tiny LM for a few steps (the port's train step);
  2. collect the FFN hidden activations H ∈ R^{tokens × d_ff} of layer 0
     on a probe batch and the layer's output t = H·W_out, pooled to one
     response y;
  3. group Lasso over neuron groups (each neuron's activation column,
     m = 1), solved along a λ path with group-EDPP screening (Cor. 21),
     which safely discards neurons whose optimal weight is exactly zero;
  4. report the neuron-sparsity/reconstruction trade-off.

    PYTHONPATH=src python examples/prune_ffn_torch.py [--device cpu]

It runs on the card unless ``--device cpu``; every group screen launches
``group_screen_scores`` there.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs.common import dense_lm
from repro_torch.core import (GroupPathConfig, group_lambda_max,
                              group_lasso_path, lambda_grid)
from repro_torch.core.device import resolve_device
from repro_torch.data import SyntheticLM, to_device
from repro_torch.models.layers import ffn_hidden, rmsnorm
from repro_torch.optim import adamw
from repro_torch.train import steps as ST

ROWS = (2, 6, 10, 14, 19)     # the grid points the table prints


def ffn_regression(model, tokens: torch.Tensor):
    """Layer 0's FFN hidden activations H (tokens × d_ff) on the
    embeddings of ``tokens`` and the pooled target y (tokens,), built as
    ``examples/prune_ffn.py`` builds them, in float32: the FFN input is
    ``rmsnorm(norm2, embed[tokens])``, H its SwiGLU hidden activations
    silu(h·W_gate)·(h·W_in), the target H·W_out pooled by its per-output
    standard deviations."""
    with torch.no_grad():
        params = model.tree()
        lp = params["segments"][0][0]["b0"]
        x = params["embed"][tokens.long()]
        h2 = rmsnorm(lp["norm2"], x)
        hidden = ffn_hidden(lp["ffn"], model.cfg.segments[0].blocks[0].ffn,
                            h2)
        target = hidden @ lp["ffn"]["w_out"]
        H = hidden.reshape(-1, hidden.shape[-1])
        tgt = target.reshape(-1, target.shape[-1])
        sd = torch.std(tgt, dim=0, correction=0)
        y = tgt @ (sd / torch.linalg.norm(sd))
    return H, y


def prune_path(H, y, *, num: int = 20, lo_frac: float = 0.02,
               rule: str = "edpp", solver_tol: float = 1e-10, device=None):
    """The group-Lasso path over neurons (m = 1) with ``rule`` screening:
    ``(grid, λ_max, result)``."""
    lmax = float(group_lambda_max(H, y, 1))
    grid = lambda_grid(lmax, num=num, lo_frac=lo_frac)
    res = group_lasso_path(H, y, 1, grid,
                           GroupPathConfig(rule=rule, solver_tol=solver_tol),
                           device=device)
    return grid, lmax, res


def table(H, y, grid, lmax, res, rows=ROWS) -> list[str]:
    """The λ/λ_max, neurons-kept, screened-out and R² lines."""
    H = H.detach().cpu().numpy().astype(np.float64)
    y = y.detach().cpu().numpy().astype(np.float64)
    out = ["  λ/λmax   neurons kept   screened-out   recon-R²"]
    for k in rows:
        beta = res.betas[k]
        kept = int((np.abs(beta) > 1e-9).sum())
        pred = H @ beta
        r2 = 1 - ((y - pred) ** 2).sum() / ((y - y.mean()) ** 2).sum()
        out.append(f"  {grid[k]/lmax:6.2f}   {kept:12d}   "
                   f"{res.stats[k].n_discarded:11d}   {r2:8.3f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--solver-tol", type=float, default=1e-10)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = dense_lm("prunable", n_layers=2, d_model=128, n_heads=4,
                   n_kv_heads=4, d_head=32, d_ff=256, vocab=4000)
    tc = ST.TrainConfig(opt=adamw.OptConfig(lr=3e-3, warmup_steps=5,
                                            total_steps=60))
    state, _ = ST.init_state(0, cfg, tc, device=device)
    src = SyntheticLM(vocab=cfg.vocab, seq=64, global_batch=4)
    step = ST.make_train_step(cfg, tc)
    for i in range(30):
        state, metrics = step(state, to_device(src.host_batch(i), device))
    print(f"trained tiny LM to loss {float(metrics['loss']):.3f}")

    # --- layer-0 FFN hidden activations on a probe batch ------------------
    tokens = to_device(src.host_batch(99), device)["tokens"]
    H, y = ffn_regression(state.params, tokens)
    grid, lmax, res = prune_path(H, y, solver_tol=args.solver_tol,
                                 device=device)
    print()
    print("\n".join(table(H, y, grid, lmax, res)))
    print("\ngroup-EDPP screened the inactive neurons SAFELY — kept set is "
          "exactly the group-lasso support at each λ.")
    return res


if __name__ == "__main__":
    main()
