"""Tiny dry-run cells for the CPU tests: the reduced config of every
architecture at tiny shapes, counted by the port's dry run
(``repro_torch.launch.dryrun.run_cell``) and by the JAX package's HLO
census (``repro.launch.hlo_analysis.analyze_hlo``) of its own ``mesh=None``
steps, lowered as its ``launch/dryrun.py`` lowers them.

The tiny shapes are registered in both packages' ``SHAPES`` and the port's
``get_config`` returns reduced configs, for one test, through
``monkeypatch``, so the port's cells run through ``run_cell`` unchanged.
Train cells run 513 tokens: the attention then takes two KV chunks of 512
and the cross entropy one chunk of 512 labels, so neither package's scan
has a single trip, and neither pads a chunk (see ``test_torch_dryrun_train``
for what one trip and a padded chunk change in the JAX package's count).
"""

import jax
import jax.numpy as jnp

from repro.core.hardware import MeshSpec as JaxMeshSpec
from repro.core.lm_planner import plan_lm as jax_plan_lm
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro.launch.hlo_analysis import analyze_hlo
from repro.models import common as jax_common
from repro.models import lm as jax_lm
from repro.models import registry as jax_registry
from repro_torch.launch import dryrun
from repro_torch.models import common as torch_common
from repro_torch.models import registry as torch_registry

BATCH = 2
TINY = {
    "tiny_prefill": {"seq": 64, "batch": BATCH, "kind": "prefill"},
    "tiny_decode": {"seq": 64, "batch": BATCH, "kind": "decode"},
    "tiny_train": {"seq": 513, "batch": BATCH, "kind": "train"},
}


def use_tiny_cells(monkeypatch):
    for name, shape in TINY.items():
        monkeypatch.setitem(jax_common.SHAPES, name, shape)
        monkeypatch.setitem(torch_common.SHAPES, name, shape)
    full = torch_registry.get_config
    monkeypatch.setattr(torch_registry, "get_config",
                        lambda arch: torch_registry.reduced_config(
                            full(arch)))


def port_cell(arch, shape, **overrides):
    return dryrun.run_cell(arch, shape, "one",
                           overrides={"microbatches": 1, **overrides})


def jax_dot_flops(arch, shape, **overrides):
    """``analyze_hlo``'s dot FLOPs of the JAX package's ``mesh=None`` step
    for the reduced ``arch`` at ``shape`` (value and gradient, with the
    optimizer, for a train cell)."""

    cfg = jax_registry.reduced_config(jax_registry.get_config(arch))
    plan = jax_plan_lm(cfg, shape, JaxMeshSpec((("data", 1),)),
                       overrides={"microbatches": 1, **overrides})
    cfg = plan.cfg
    params = jax_lm.abstract_params(cfg)
    specs = jax_registry.input_specs(cfg, shape)
    kind = TINY[shape]["kind"]
    if kind == "train":
        step, _, _ = jax_train.build_train_step(plan, None)
        optimizer = jax_train.make_optimizer(plan)
        state = {"params": params,
                 "opt": jax.eval_shape(lambda: optimizer.init(params)),
                 "step": jax.ShapeDtypeStruct((), jnp.int32)}
        lowered = step.lower(state, specs)
    elif kind == "prefill":
        step, _ = jax_serve.build_prefill_step(plan, None,
                                               TINY[shape]["seq"])
        lowered = step.lower(params, specs)
    else:
        step, _, _ = jax_serve.build_decode_step(plan, None)
        lowered = step.lower(params, specs["cache"], specs["token"],
                             specs["pos"])
    return analyze_hlo(lowered.compile().as_text(), 1, 0).dot_flops
