"""The reference's dry-run numbers for the port's dry-run tests.

``python tests/torch_dryrun_reference.py`` (PYTHONPATH=src:tests) prints
one JSON object: ``params`` ({arch: [total, active]}), ``model_flops``
({"arch|shape": flops}) for every catalogue cell, and ``lasso_record``,
the reference's ``run_cell`` record of ``lasso-screen-16m`` on (16, 16)
(its keys are the record's keys). It runs in a process of its own:
importing ``repro.launch.dryrun`` forces 512 host devices for every
later JAX user of its process.

``--dots`` prints instead, for each tiny arch with and without remat,
the train step's products as the reference's loop-aware model counts
them (:func:`reference_dots`) and as the port's dry run counts them
(:func:`port_dots`): the table PERF.md §6 holds. ``--dots-by-size ARCH``
prints, without remat, how many products of each flop count either
side runs, where the two differ (the breakdown PERF.md §6 gives).
"""

import dataclasses
import json
import sys

SEQ, BATCH = 32, 4


def reference_step_hlo(arch: str, remat: bool):
    """The reference's compiled f32 train step of the tiny ``arch`` on an
    auto-typed 1×1 mesh (``jax.make_mesh``'s explicit axes refuse its
    ``jnp.take``), parsed by its loop-aware model."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from repro import configs as JC
    from repro.data import SyntheticLM, device_batch
    from repro.launch import hlo_cost as JHC
    from repro.train import steps as JST

    jc = dataclasses.replace(JC.get_tiny(arch), remat=remat)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jt = JST.TrainConfig(compute_dtype="float32", fp32_grads=True)
    js, jsh = JST.init_state(jax.random.PRNGKey(0), jc, jt, mesh)
    src = SyntheticLM(vocab=jc.vocab, seq=SEQ, global_batch=BATCH,
                      frontend=jc.frontend, d_frame=jc.d_frame,
                      d_patch=jc.d_patch, n_img_tokens=jc.n_img_tokens)
    b0 = device_batch(mesh, src.host_batch(0))
    step = JST.make_train_step(jc, jt, mesh, jsh,
                               {k: v.sharding for k, v in b0.items()})
    return JHC.HloModule(step.lower(js, b0).compile().as_text())


def reference_dots(arch: str, remat: bool) -> float:
    """The reference's products: the dot and convolution flops of its
    loop-aware model (:func:`reference_step_hlo`)."""
    mod = reference_step_hlo(arch, remat)
    keep = mod._instr_cost

    def dots_only(ins, top_level):
        c = keep(ins, top_level)
        if ins.opcode not in ("dot", "convolution"):
            c.flops = 0.0
        return c

    mod._instr_cost = dots_only
    return mod.module_cost().flops


def port_dots(arch: str, remat: bool) -> float:
    """The port's products in the same step, traced on fake tensors."""
    from repro_torch import configs as TC
    from repro_torch.launch import dryrun
    from repro_torch.train import steps as ST

    cfg = dataclasses.replace(TC.get_tiny(arch), remat=remat)
    tc = ST.TrainConfig(compute_dtype="float32", fp32_grads=True)
    return dryrun.trace_step(cfg, TC.ShapeSpec("t", "train", SEQ, BATCH),
                             None, tc, device="cpu")["mode"].dot_flops


def dots_by_size(arch: str) -> None:
    """Without remat: {flops of one product: how many} on either side,
    printed where they differ (the reference's products inside a loop
    counted once per trip)."""
    import collections

    from repro_torch.launch import hlo_cost

    mod = reference_step_hlo(arch, False)
    ref = collections.Counter()

    def walk(comp, trips):
        for ins in mod.computations.get(comp, []):
            if ins.opcode == "while":
                walk(mod._called(ins.attrs, "body"),
                     trips * mod.trip_count(mod._called(ins.attrs,
                                                        "condition")))
            elif ins.opcode in ("fusion", "call"):
                walk(mod._called(ins.attrs, "calls")
                     or mod._called(ins.attrs, "to_apply"), trips)
            elif ins.opcode == "dot":
                ref[round(mod._dot_flops(ins))] += trips

    walk(mod.entry, 1)
    port = collections.Counter()
    count = hlo_cost.CostMode.__torch_dispatch__

    def counted(self, func, types, args=(), kwargs=None):
        before = self.dot_flops
        out = count(self, func, types, args, kwargs)
        if self.dot_flops != before:
            port[round(self.dot_flops - before)] += 1
        return out

    hlo_cost.CostMode.__torch_dispatch__ = counted
    try:
        port_dots(arch, False)
    finally:
        hlo_cost.CostMode.__torch_dispatch__ = count
    for size in sorted(set(ref) | set(port)):
        if ref[size] != port[size]:
            print(f"{arch}: products of {size} flops: reference {ref[size]}"
                  f", port {port[size]} ({(port[size] - ref[size]) * size:+d}"
                  f" flops)")


def dots_table() -> None:
    from repro import configs as JC
    for arch in JC.ARCHS:
        for remat in (True, False):
            ref, port = reference_dots(arch, remat), port_dots(arch, remat)
            print(f"{arch} remat={remat}: reference {ref:.0f} port "
                  f"{port:.0f} port/reference {port / ref:.4f}", flush=True)


def main() -> None:
    from repro import configs
    from repro.launch import dryrun as D
    params = {a: list(D.param_counts(configs.get_config(a)))
              for a in configs.ARCHS}
    flops = {f"{a}|{s}": D.model_flops(a, s)
             for a in configs.ARCHS for s in configs.SHAPES}
    rec = D.run_cell("lasso-screen-16m", "lasso", False)
    print(json.dumps({"params": params, "model_flops": flops,
                      "lasso_record": rec}))


if __name__ == "__main__":
    if sys.argv[1:] == ["--dots"]:
        dots_table()
    elif sys.argv[1:2] == ["--dots-by-size"]:
        dots_by_size(sys.argv[2])
    else:
        main()
