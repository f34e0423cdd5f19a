"""The dry run's claim of the card (``repro_torch.launch.dryrun``,
``--device cuda``): the tiny archs' prefill and decode steps traced on
fake CUDA tensors count what the same steps count on real CPU tensors
(tests/test_torch_dryrun.py holds the fake CPU traces to those), but for
the copies of host scalars to the card.

A torch built without CUDA cannot index fake CUDA tensors; the module's
tests lend it a no-op guard (tests/torch_fake_cuda.py)."""

import pytest
import torch

from repro_torch import configs as TC
from repro_torch.launch import dryrun
from repro_torch.train import steps as ST
from test_torch_dryrun import BATCH, SEQ, _real
from torch_fake_cuda import cuda_guard

CASES = [(a, k) for a in TC.ARCHS for k in ("prefill", "decode")
         if not (k == "decode" and TC.get_tiny(a).encoder_only)]

# ops whose operands or results differ by device: host scalars copied to
# the card (32 bytes in codeqwen's prefill, 96 in gemma3's) and
# log_sigmoid's CPU-only buffer (xlstm), read on a CPU
DEVICE_OPS = {"_to_copy", "log_sigmoid_forward"}


@pytest.fixture(scope="module", autouse=True)
def fake_cuda():
    with cuda_guard():
        yield


@pytest.mark.parametrize("arch,kind", CASES)
def test_the_card_claim_counts_the_same_step(arch, kind):
    """Fake CUDA tensors against real CPU tensors: the same flops and
    fused bytes; the unfused bytes differ only in ``DEVICE_OPS``, by
    under 1 KiB of ``_to_copy``."""
    cfg = TC.get_tiny(arch)
    tc = ST.TrainConfig()
    cpu = _real(cfg, kind, tc)
    traced = dryrun.trace_step(cfg, TC.ShapeSpec(kind, kind, SEQ, BATCH),
                               None, tc, device="cuda")
    card = traced["mode"]
    assert traced["device"] == "cuda"
    assert card.dot_flops == cpu.dot_flops
    assert card.cost.flops == cpu.cost.flops
    assert card.cost.bytes_fused == cpu.cost.bytes_fused
    ops = set(card.bytes_by_op) | set(cpu.bytes_by_op)
    assert {k for k in ops
            if card.bytes_by_op[k] != cpu.bytes_by_op[k]} <= DEVICE_OPS
    assert 0 <= card.bytes_by_op["_to_copy"] - cpu.bytes_by_op[
        "_to_copy"] < 1024


def test_a_card_train_step_needs_a_cuda_build_of_torch():
    """The default claims the card only where torch is built with CUDA;
    a train step claimed on the card is refused where it is not
    (autograd asks the card for a stream)."""
    cfg, shape = TC.get_tiny("yi-9b"), TC.ShapeSpec("t", "train", SEQ, BATCH)
    traced = dryrun.trace_step(cfg, shape, None)
    assert traced["device"] == ("cuda" if torch.backends.cuda.is_built()
                                else "cpu")
    if not torch.backends.cuda.is_built():
        with pytest.raises(RuntimeError, match="built with CUDA"):
            dryrun.trace_step(cfg, shape, None, device="cuda")
