"""The dry run's counts (``repro_torch.launch.dryrun``) on one device, held
against the port's own real steps.

* Fake against real: every tiny arch's train, prefill and decode step
  traced on fake tensors counts the flops (products and elementwise),
  the bytes and the fused bytes of the same step run on real CPU tensors
  under the same ``CostMode``, exactly.
tests/test_torch_dryrun_card.py holds the card's claim (fake CUDA
tensors) against the real CPU steps, tests/test_torch_dryrun_reference.py
the counts against the reference's cost model.
"""

import pytest
import torch

from repro_torch import configs as TC
from repro_torch.data import SyntheticLM, to_device
from repro_torch.launch import dryrun, hlo_cost
from repro_torch.models import model as M
from repro_torch.train import steps as ST

SEQ, BATCH = 32, 4
CASES = [(a, k) for a in TC.ARCHS for k in ("train", "prefill", "decode")
         if not (k == "decode" and TC.get_tiny(a).encoder_only)]


def _source(cfg, seq=SEQ, batch=BATCH) -> SyntheticLM:
    return SyntheticLM(vocab=cfg.vocab, seq=seq, global_batch=batch,
                       frontend=cfg.frontend, d_frame=cfg.d_frame,
                       d_patch=cfg.d_patch, n_img_tokens=cfg.n_img_tokens)


def _real(cfg, kind: str, tc: ST.TrainConfig) -> hlo_cost.CostMode:
    """The step of ``kind`` on real CPU tensors of the dry run's shapes,
    counted."""
    state, _ = ST.init_state(0, cfg, tc, device="cpu")
    batch = to_device(_source(cfg).host_batch(0), "cpu")
    if kind == "train":
        step, args = ST.make_train_step(cfg, tc), (state, batch)
    elif kind == "prefill":
        batch.pop("labels")
        step, args = ST.make_prefill_step(cfg, tc), (state.params, batch)
    else:
        caches = M.cache_init(cfg, BATCH, SEQ, device="cpu")
        tok = torch.zeros((BATCH, 1), dtype=torch.int32)
        step = ST.make_decode_step(cfg, tc)
        args = (state.params, tok, caches, SEQ - 1)
    with hlo_cost.CostMode() as mode:
        step(*args)
    return mode


@pytest.mark.parametrize("arch,kind", CASES)
def test_fake_step_counts_what_the_real_step_counts(arch, kind):
    """Fake CPU tensors against real CPU tensors: every count equal."""
    cfg = TC.get_tiny(arch)
    tc = ST.TrainConfig()
    shape = TC.ShapeSpec(kind, kind, SEQ, BATCH)
    fake = dryrun.trace_step(cfg, shape, None, tc, device="cpu")["mode"]
    real = _real(cfg, kind, tc)
    assert fake.dot_flops == real.dot_flops > 0
    assert fake.cost.flops == real.cost.flops
    assert fake.cost.bytes == real.cost.bytes
    assert fake.cost.bytes_fused == real.cost.bytes_fused
