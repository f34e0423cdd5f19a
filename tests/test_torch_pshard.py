"""The port's logical-axis sharding (``repro_torch.pshard``,
``repro_torch.launch.mesh``, ``models.model.param_specs``) against the
reference's (``repro.pshard``, ``repro.launch.mesh``,
``repro.models.model.param_specs``) on the CPU:

* ``physical_axes``, ``resolve_spec`` (dims that divide and dims that do
  not, which fall back to replication), ``batch_axes`` and
  ``batch_spec`` (with its degrade for a batch the batch axes do not
  divide) equal the reference's on stand-in meshes (axis names and
  sizes: both packages read nothing else) of (1, 1), (2, 2), (4, 1),
  (1, 4), (16, 16) and (2, 16, 16);
* every parameter's logical spec for all ten configs, tiny and full
  (the port's on the meta device, the reference's through
  ``jax.eval_shape``), equal to the reference's leaf by leaf, a stacked
  segment leaf's without its leading ``None``; and the resolved specs on
  (2, 2), (16, 16) and (2, 16, 16) too; the decode caches' specs
  (``cache_specs`` against ``cache_init_specs``) likewise;
* each rank's block of every leaf (``Layout.index``) on a (2, 2) mesh
  equal to the reference's ``addressable_shards`` of a ``NamedSharding``
  array on 4 forced host devices, in a subprocess
  (tests/torch_pshard_reference.py);
* ``mesh_shape_for(d)`` equal to the reference's ``make_mesh_for(d)``
  for d = 1 … 512, and the production meshes' axes and sizes.
"""

import itertools
import os
import subprocess
import sys

import numpy as np
import jax
import pytest

from repro import configs as JC
from repro import pshard as JP
from repro.models import model as JM
from repro_torch import configs as TC
from repro_torch import pshard as TP
from repro_torch.convert import _to_ref_tree
from repro_torch.launch import mesh as TMESH
from repro_torch.models import model as TM
from repro_torch.train import sharding as TSH

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = [(1, 1), (2, 2), (4, 1), (1, 4), (16, 16), (2, 16, 16)]
PLACED = [(2, 2), (16, 16), (2, 16, 16)]
LOGICAL = [*JP.DEFAULT_RULES, None, "not-a-rule"]
DIMS = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 100, 256, 512, 4096)


def stand_in(dims) -> TP.MeshShape:
    return TP.MeshShape(TMESH.mesh_axes(dims), tuple(dims))


@pytest.mark.parametrize("dims", MESHES)
def test_physical_axes_and_resolve_spec_match_the_reference(dims):
    mesh = stand_in(dims)
    for logical in LOGICAL:
        assert TP.physical_axes(mesh, logical) == JP.physical_axes(
            mesh, logical)
    rng = np.random.default_rng(sum(dims))
    for _ in range(400):
        ndim = int(rng.integers(1, 5))
        spec = tuple(LOGICAL[i] for i in rng.integers(0, len(LOGICAL),
                                                      int(rng.integers(
                                                          0, ndim + 1))))
        shape = tuple(int(DIMS[i]) for i in rng.integers(0, len(DIMS), ndim))
        got = TSH.resolve_spec(mesh, TP.P(*spec), shape)
        assert got == JP.resolve_spec(mesh, JP.P(*spec), shape), (spec,
                                                                   shape)
        assert isinstance(got, TP.P) and len(got) == ndim


@pytest.mark.parametrize("dims", MESHES)
def test_batch_spec_matches_the_reference(dims):
    mesh = stand_in(dims)
    assert TP.batch_axes(mesh) == JP.batch_axes(mesh)
    for ndim, dim0 in itertools.product(range(1, 5), (None, *DIMS)):
        assert TP.batch_spec(mesh, ndim, dim0) == JP.batch_spec(
            mesh, ndim, dim0), (ndim, dim0)


def _reference_leaves(tree) -> dict:
    """{port name: reference leaf} with a stacked segment leaf given once
    per layer (the port's names), as ``convert`` maps them."""
    out = {}

    def walk(node, prefix, seg):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.", seg)
            elif seg is None:
                out[f"{prefix}{k}"] = v
            else:
                out[(seg, f"{prefix}{k}")] = v

    walk({k: v for k, v in tree.items() if k != "segments"}, "", None)
    for si, seg in enumerate(tree.get("segments", [])):
        walk(seg, "", si)
    return out


def _stacked(name: str):
    parts = name.split(".")
    if parts[0] == "segments":
        return int(parts[1]), ".".join(parts[3:])
    return None


@pytest.fixture(scope="module", params=["tiny", "full"])
def specs(request):
    """{arch: (port cfg, port specs, port shapes, reference specs by port
    key, reference shapes by port key)}."""
    out = {}
    for arch in TC.ARCHS:
        get = "get_tiny" if request.param == "tiny" else "get_config"
        jc, tc = getattr(JC, get)(arch), getattr(TC, get)(arch)
        shapes = jax.eval_shape(lambda k: JM.init_params(k, jc)[0],
                                jax.random.PRNGKey(0))
        model = TM.LM(tc, device="meta")
        out[arch] = (tc, TM.param_specs(tc),
                     {n: tuple(p.shape) for n, p in model.named_parameters()},
                     _reference_leaves(JM.param_specs(jc)),
                     _reference_leaves(shapes))
    return out


@pytest.mark.parametrize("arch", list(TC.ARCHS))
def test_param_specs_match_the_reference(specs, arch):
    _, port, shapes, ref, ref_shapes = specs[arch]
    seen = set()
    for name, spec in port.items():
        key = _stacked(name) or name
        want = tuple(ref[key])
        if key != name:                  # the stacking axis
            assert want[0] is None
            want = want[1:]
            assert tuple(ref_shapes[key].shape[1:]) == shapes[name]
        else:
            assert tuple(ref_shapes[key].shape) == shapes[name]
        assert isinstance(spec, TP.P) and spec == want, name
        seen.add(key)
    assert seen == set(ref)


@pytest.mark.parametrize("arch", list(TC.ARCHS))
def test_cache_specs_match_the_reference(arch):
    jc, tc = JC.get_config(arch), TC.get_config(arch)
    want = JM.cache_init_specs(jc, 1, 8)
    got = TM.cache_specs(tc)
    assert len(got) == len(want)
    for seg, gseg, wseg in zip(tc.segments, got, want):
        assert len(gseg) == seg.repeat
        for layer in gseg:
            assert sorted(layer) == sorted(wseg)
            for b, caches in layer.items():
                assert sorted(caches) == sorted(wseg[b])
                for k, spec in caches.items():
                    stacked = tuple(wseg[b][k])
                    assert stacked[0] is None and spec == stacked[1:], (
                        b, k, spec, stacked)


@pytest.mark.parametrize("dims", PLACED)
@pytest.mark.parametrize("arch", list(TC.ARCHS))
def test_resolved_specs_match_the_reference(specs, arch, dims):
    _, port, shapes, ref, ref_shapes = specs[arch]
    mesh = stand_in(dims)
    layouts = TP.resolve_tree(mesh, port, shapes)
    for name, lay in layouts.items():
        key = _stacked(name) or name
        want = JP.resolve_spec(mesh, ref[key], ref_shapes[key].shape)
        if key != name:
            assert want[0] is None
            want = tuple(want)[1:]
        assert lay.spec == tuple(want), (name, lay.spec, want)
        assert lay.shape == shapes[name]


@pytest.fixture(scope="module")
def reference_meshes(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pshard") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(HERE), "src"), HERE]))
    run = subprocess.run([sys.executable, os.path.join(
        HERE, "torch_pshard_reference.py"), out], env=env,
        capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    with np.load(out) as f:
        return dict(f)


def _paths(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        return {k: v for key, node in tree.items()
                for k, v in _paths(node, f"{prefix}{key}.").items()}
    if isinstance(tree, list):
        return {k: v for i, node in enumerate(tree)
                for k, v in _paths(node, f"{prefix}{i}.").items()}
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("arch", list(TC.ARCHS))
def test_rank_blocks_match_the_reference_addressable_shards(
        reference_meshes, arch):
    cfg = TC.get_tiny(arch)
    mesh = stand_in((2, 2))
    model = TM.LM(cfg, device="meta")
    layouts = TP.resolve_tree(mesh, model.specs(),
                              dict(model.named_parameters()))
    stacked = _paths(_to_ref_tree(layouts, leaf=lambda x: x))
    want = {k[len(arch) + 1:]: v for k, v in reference_meshes.items()
            if k.startswith(arch + "|")}
    assert set(stacked) == set(want)
    for path, lay in stacked.items():
        rows = []
        for d, m in itertools.product(range(2), range(2)):
            row = [d, m]
            for sl in lay.index({"data": d, "model": m}):
                row += [sl.start, sl.stop]
            rows.append(row)
        np.testing.assert_array_equal(np.array(sorted(rows)), want[path],
                                      err_msg=path)


def test_mesh_shapes_match_the_reference(reference_meshes):
    got = np.array([list(TMESH.mesh_shape_for(d).dims)
                    for d in range(1, 513)])
    np.testing.assert_array_equal(got, reference_meshes["mesh_for"])
    for tag, multi in (("production", False), ("production_multi_pod",
                                               True)):
        m = TMESH.production_mesh_shape(multi_pod=multi)
        assert [f"{a}={n}" for a, n in m.shape.items()] == \
            reference_meshes[tag].tolist()
