"""bfloat16 leaves in checkpoints, between the port
(``repro_torch.checkpoint``) and the reference (``repro.checkpoint``):

* the port writes a bf16 tensor as the reference writes a jax bf16
  array: ``np.savez`` stores its 16-bit patterns as a 2-byte void array
  (``|V2``) and the manifest's ``dtypes`` entry reads ``"bfloat16"``;
  the two files' leaves hold the same bytes. The reference's
  ``restore`` cannot take such a leaf, its own included (``jnp.asarray``
  refuses the void array ``np.load`` returns: a reference caveat), so
  the reference side reads the port's file with its own loader
  (``np.load`` and the manifest) and views the leaf as ``jnp.bfloat16``:
  the same bits;
* a reference-saved bf16 leaf restores in the port as ``torch.bfloat16``
  with the same bits;
* a ``TrainState`` with ``OptConfig(moment_dtype="bfloat16")`` (tiny
  xlstm, after a step) round-trips in the port leaf for leaf, and the
  resumed step equals the uninterrupted one bit for bit.
"""

import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro import checkpoint as jckpt
from repro_torch import checkpoint as tckpt
from repro_torch import configs as TC
from repro_torch.convert import (train_state_from_reference,
                                 train_state_to_reference)
from repro_torch.data import SyntheticLM, to_device
from repro_torch.optim import adamw as TA
from repro_torch.train import steps as TST

# bf16 bit patterns: 0, 1, 2, −123.5, +inf, the smallest subnormal, NaN
BITS = np.array([0x0000, 0x3F80, 0x4000, 0xC2F7, 0x7F80, 0x0001, 0x7FC1],
                np.uint16)


def _trees():
    """The same leaves as a jax tree and a torch tree: a bf16 vector, an
    f32 matrix and an int32 scalar."""
    f32 = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    jt = {"m": jax.lax.bitcast_convert_type(jnp.asarray(BITS), jnp.bfloat16),
          "p": jnp.asarray(f32), "step": jnp.asarray(3, jnp.int32)}
    tt = {"m": torch.from_numpy(BITS.view(np.int16)).view(torch.bfloat16),
          "p": torch.from_numpy(f32), "step": torch.tensor(3,
                                                           dtype=torch.int32)}
    return jt, tt


def _step_dir(d, step):
    return os.path.join(d, f"step_{step:08d}")


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def test_port_bf16_leaf_is_what_the_reference_writes(tmp_path):
    jt, tt = _trees()
    jckpt.save(str(tmp_path / "j"), 3, jt)
    tckpt.save(str(tmp_path / "t"), 3, tt)
    files = {}
    for pkg in ("j", "t"):
        d = _step_dir(str(tmp_path / pkg), 3)
        with open(os.path.join(d, "manifest.json")) as f:
            man = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            files[pkg] = (man, {k: data[k] for k in data.files})
    (jm, ja), (tm, ta) = files["j"], files["t"]
    assert tm["dtypes"] == jm["dtypes"] == ["bfloat16", "float32", "int32"]
    assert tm["shapes"] == jm["shapes"] and sorted(ta) == sorted(ja)
    for k in ja:
        assert ta[k].dtype == ja[k].dtype
        assert ta[k].tobytes() == ja[k].tobytes()
    assert ta["leaf_0"].dtype == np.dtype("V2")
    # the reference's reader on the port's file: the leaf viewed as its
    # manifest's dtype holds the same bits
    leaf = jnp.asarray(ta["leaf_0"].view(np.uint16)).view(jnp.bfloat16)
    assert leaf.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jax.lax.bitcast_convert_type(leaf, jnp.uint16)), BITS)
    # the reference's restore refuses the void leaf, its own file's too
    for pkg in ("j", "t"):
        with pytest.raises(TypeError, match="V2"):
            jckpt.restore(str(tmp_path / pkg), 3, jt)


def test_reference_bf16_leaf_restores_in_the_port(tmp_path):
    jt, tt = _trees()
    jckpt.save(str(tmp_path), 3, jt)
    got, _ = tckpt.restore(str(tmp_path), 3, tt, device="cpu")
    assert got["m"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["m"]), BITS)
    assert got["p"].dtype == torch.float32 and torch.equal(got["p"], tt["p"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 3
    # and the port's own file back into the port
    tckpt.save(str(tmp_path / "t"), 3, tt)
    back, _ = tckpt.restore(str(tmp_path / "t"), 3, tt, device="cpu")
    np.testing.assert_array_equal(_bits(back["m"]), BITS)


def test_train_state_with_bf16_moments_round_trips(tmp_path):
    cfg = TC.get_tiny("xlstm-350m")
    tc = TST.TrainConfig(opt=TA.OptConfig(lr=5e-3, warmup_steps=1,
                                          moment_dtype="bfloat16"))
    src = SyntheticLM(vocab=cfg.vocab, seq=16, global_batch=2)
    step = TST.make_train_step(cfg, tc)
    state, _ = TST.init_state(0, cfg, tc, device="cpu")
    state, _ = step(state, to_device(src.host_batch(0), "cpu"))
    saved = train_state_to_reference(state)
    tckpt.save(str(tmp_path), 1, saved)
    tree, _ = tckpt.restore(str(tmp_path), 1, saved, device="cpu")
    back = train_state_from_reference(tree, cfg, device="cpu")
    want = jax.tree.leaves(saved)
    got = jax.tree.leaves(train_state_to_reference(back))
    assert len(got) == len(want)
    n_bf16 = 0
    for w, g in zip(want, got):
        if isinstance(w, torch.Tensor):
            assert w.dtype == g.dtype == torch.bfloat16
            assert torch.equal(w.view(torch.int16), g.view(torch.int16))
            n_bf16 += 1
        else:
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(w, g)
    assert n_bf16 == 2 * len(jax.tree.leaves(saved.opt.m)) and {
        t.dtype for t in back.opt.v.values()} == {torch.bfloat16}
    batch = to_device(src.host_batch(1), "cpu")
    a, ma = step(state, batch)
    b, mb = step(back, batch)
    assert float(ma["loss"]) == float(mb["loss"])
    for (k, p), q in zip(a.params.named_parameters(), b.params.parameters()):
        assert torch.equal(p, q), k
