"""The dry run's products held against the reference's loop-aware HLO cost
model (``repro.launch.hlo_cost``) of its jitted train step: f32 with f32
gradients, 4 × 32 tokens, the tiny configs, the reference's step on an
auto-typed 1×1 mesh with its dots counted apart (the model's flops of
every other opcode set to 0).

Without remat a dense arch's products are the reference's exactly. With
remat (the configs' default) the port recomputes every block's whole
forward in the backward (``torch.utils.checkpoint``), while XLA drops the
recomputed products whose results the backward does not read; the MoE
dispatch and the SSD and mLSTM chunk algebra differ too. Readings (port
over reference dots; ``python tests/torch_dryrun_reference.py --dots``,
read on a CPU; PERF.md §6 has all ten archs): yi-9b 1.0112, deepseek-v2-
lite-16b 1.0671; without remat yi-9b 1.0000. Each case is held to its
reading within 0.005.
"""

import pytest

from torch_dryrun_reference import port_dots, reference_dots

# (arch, remat): the port's dots over the reference's, read on a CPU
DOT_RATIOS = {("yi-9b", True): 1.0112, ("deepseek-v2-lite-16b", True): 1.0671,
              ("yi-9b", False): 1.0}


@pytest.mark.parametrize("arch,remat", list(DOT_RATIOS))
def test_train_step_dots_against_the_reference(arch, remat):
    ratio = port_dots(arch, remat) / reference_dots(arch, remat)
    assert abs(ratio - DOT_RATIOS[arch, remat]) <= 0.005, ratio
    if not remat:
        assert ratio == 1.0
