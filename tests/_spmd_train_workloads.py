"""The LM train step on a ``(data 4, model 2)`` mesh, in both packages:
shared inputs, the JAX package's 8-device program and the port's rank
program of ``test_torch_spmd_train.py``.

The cells (``CELLS``):

* ``zero1`` — the reference's own cell (``spmd_program.py``'s LM train
  step): reduced minitron-8b, ``plan_lm`` on ``TPU_V5E`` (ZeRO-1), 2
  microbatches, ``adamw(lr=1e-3)``, 4 steps of the same (8, 32) tokens;
* ``zero3_masked`` — the same model with the plan replaced to ZeRO-3
  (``rules.fsdp``) and a ``mask`` that leaves the microbatches' and the
  data shards' token counts unequal;
* ``arctic`` — reduced arctic-480b (MoE with EP over ``model`` and the
  dense residual) under ZeRO-3, 2 steps (ROADMAP A10f's sharding);
* ``minicpm3`` — reduced minicpm3-4b (MLA: ``q_up``/``k_up``/``v_up``
  over ``model``, the latents whole) under ZeRO-1, 2 steps (A10h-1);
* ``whisper`` — reduced whisper-medium (the encoder's and the decoder's
  self- and cross-attention over ``model``) under ZeRO-1, 2 steps, its
  batch carrying ``enc_input`` frames (A10h-1);
* ``mamba2`` — reduced mamba2-130m (8 SSM heads, the SSD mixer whole on
  every ``model`` rank, the tied table as the vocab-parallel lookup, head
  and loss) with its published vocab of 50,280 (``config``; padded to
  50,432, so tokens and gradient land in both ``model`` ranks' blocks of
  the tied table) under ZeRO-3, so the tied table is gathered for each
  use, 2 steps (A10h-2);
* ``hymba`` — reduced hymba-1.5b with hymba's published 25 / 5 head
  ratio as 5 q / 1 kv heads (``config``, given to both packages): 2
  divides neither, so the planner keeps ``qkv`` whole and the attention
  half runs replicated beside the replicated SSM half, as the
  reference's (A10h-3, case (ii)); window 16; ZeRO-1, 2 steps (A10h-2);
* ``hymba_tp`` — reduced hymba-1.5b as it is (4 q / 2 kv heads): the
  attention half tensor parallel over ``model`` beside the replicated SSM
  half, so ``h``'s gradient is the attention's all-reduced part plus the
  SSM's whole part; ZeRO-1, 2 steps (A10h-2);
* ``minitron_kv1`` — reduced minitron-8b with 1 kv head (``config``): 2
  divides its 4 q heads, not its kv head, which is gathered whole and
  repeated to the rank's q heads (A10h-3, case (i)); ZeRO-1, 2 steps.

The weights and tokens are numpy arrays made from a seed
(:func:`make_inputs`, written to a directory as ``.npz``): the JAX
program (``python _spmd_train_workloads.py DIR``, 8 virtual devices)
and the 8 ``gloo`` ranks (:func:`rank_main`) read the same files.  Trees
travel flat, keyed by ``/``-joined paths.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
from pathlib import Path

import numpy as np

MESH = ((4, 2), ("data", "model"))
CELLS = {
    "zero1": {"arch": "minitron_8b", "fsdp": False, "mask": False,
              "steps": 4},
    "zero3_masked": {"arch": "minitron_8b", "fsdp": True, "mask": True,
                     "steps": 4},
    "arctic": {"arch": "arctic_480b", "fsdp": True, "mask": False,
               "steps": 2},
    "minicpm3": {"arch": "minicpm3_4b", "fsdp": False, "mask": False,
                 "steps": 2},
    "whisper": {"arch": "whisper_medium", "fsdp": False, "mask": False,
                "steps": 2},
    "mamba2": {"arch": "mamba2_130m", "fsdp": True, "mask": False,
               "steps": 2, "config": {"vocab": 50280}},
    "hymba": {"arch": "hymba_1_5b", "fsdp": False, "mask": False,
              "steps": 2, "config": {"n_heads": 5, "n_kv_heads": 1}},
    "hymba_tp": {"arch": "hymba_1_5b", "fsdp": False, "mask": False,
                 "steps": 2},
    "minitron_kv1": {"arch": "minitron_8b", "fsdp": False, "mask": False,
                     "steps": 2, "config": {"n_kv_heads": 1}},
}
MICROBATCHES = 2
LR = 1e-3
BATCH = (8, 32)
# Tokens kept a row in the masked cell: unequal across each microbatch's
# data shards and between the two microbatches.
KEEP = (32, 5, 20, 32, 9, 32, 14, 27)
SEED = 0
# The cell run twice (the second time with the backward in another
# thread).
AGAIN = "zero3_masked"


def flat(tree, prefix=""):
    """``{path: leaf}`` of a nested dict (NamedTuples by field name)."""

    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return flat(tree._asdict(), prefix)
    return {prefix[:-1]: tree}


def nest(flat_tree):
    out = {}
    for path, v in flat_tree.items():
        keys = path.split("/")
        d = out
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = v
    return out


def _init_leaf(spec, stacked, n_layers, rng):
    shape = ((stacked,) + spec.shape) if stacked else spec.shape
    if spec.init == "zeros":
        return np.zeros(shape, np.float32)
    if spec.init == "ones":
        return np.ones(shape, np.float32)
    scale = 0.02
    if spec.init == "small_normal":
        scale = 0.02 / max(1.0, (2.0 * n_layers) ** 0.5)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def port_config(arch):
    from repro_torch.models.registry import get_config, reduced_config

    return reduced_config(get_config(arch))


def cell_config(cell):
    """The cell's reduced config in the port, with the cell's ``config``
    overrides (the same ones the JAX program gives its own)."""

    return dataclasses.replace(port_config(cell["arch"]),
                               **cell.get("config", {}))


def _cell_plan(plan, cell):
    """The planner's plan (either package's) as the cell sets it: ZeRO-3
    where ``fsdp``."""

    if cell["fsdp"]:
        plan = dataclasses.replace(
            plan, zero="zero3",
            rules=dataclasses.replace(plan.rules, fsdp=True))
    return plan


def make_inputs(d):
    """Write each cell's weights (``{cell}_params.npz``) and batch
    (``{cell}_batch.npz``) to ``d``, from ``SEED``."""

    from repro_torch.models import lm

    for i, (name, cell) in enumerate(CELLS.items()):
        cfg = cell_config(cell)
        rng = np.random.default_rng([SEED, i])
        params = {}
        for k, sub in lm.model_specs(cfg).items():
            stacked = lm.n_stack(cfg, k)
            for path, spec in flat(sub, f"{k}/").items():
                params[path] = _init_leaf(spec, stacked, cfg.n_layers, rng)
        np.savez(Path(d) / f"{name}_params.npz", **params)
        batch = {"tokens": rng.integers(0, cfg.vocab, BATCH).astype(
            np.int32)}
        if cfg.family == "encdec":
            batch["enc_input"] = rng.standard_normal(
                (BATCH[0], cfg.enc_seq, cfg.d_model)).astype(np.float32)
        if cell["mask"]:
            batch["mask"] = (np.arange(BATCH[1])[None, :]
                             < np.array(KEEP)[:, None]).astype(np.int32)
        np.savez(Path(d) / f"{name}_batch.npz", **batch)


def load(d, name, what):
    with np.load(Path(d) / f"{name}_{what}.npz") as f:
        return {k: f[k] for k in f.files}


# ---------------------------------------------------------------------------
# The JAX package on 8 virtual devices (run as a program)
# ---------------------------------------------------------------------------


def jax_main(d):
    """Every cell through the reference's ``build_train_step`` on a
    ``(4, 2)`` mesh of 8 virtual devices; writes ``{cell}_jax.npz``: each
    step's loss and grad norm, the final params and moments, and every
    leaf's shard shape; and the same from the cell's one-device step under
    ``single/``."""

    import jax
    import jax.numpy as jnp

    from repro.core.hardware import MeshSpec
    from repro.core.lm_planner import plan_lm
    from repro.launch.mesh import make_compat_mesh
    from repro.launch.train import build_train_step
    from repro.models.registry import get_config, reduced_config
    from repro.optim import adamw

    def run(step, state, batch, steps, tag, out):
        losses, norms = [], []
        for _ in range(steps):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        out[f"{tag}losses"] = np.array(losses)
        out[f"{tag}grad_norms"] = np.array(norms)
        for part, tree in (("params", state["params"]),
                           ("m", state["opt"].m), ("v", state["opt"].v)):
            for path, a in flat(tree).items():
                out[f"{tag}{part}/{path}"] = np.asarray(a)
        return state

    mesh = make_compat_mesh(*MESH)
    for name, cell in CELLS.items():
        cfg = dataclasses.replace(reduced_config(get_config(cell["arch"])),
                                  **cell.get("config", {}))
        plan = plan_lm(cfg, "train_4k", MeshSpec(tuple(zip(MESH[1],
                                                            MESH[0]))))
        plan = _cell_plan(dataclasses.replace(plan, cfg=cfg,
                                              microbatches=MICROBATCHES),
                          cell)
        opt = adamw(lr=LR)
        def host_params():
            return jax.tree_util.tree_map(jnp.asarray,
                                          nest(load(d, name, "params")))

        host = {k: jnp.asarray(v) for k, v in load(d, name, "batch").items()}
        out = {}
        # The same cell on one device (the step donates its state): the
        # distance across worlds.
        step, _, _ = build_train_step(plan, None, optimizer=opt)
        single = host_params()
        run(step, {"params": single, "opt": opt.init(single),
                   "step": jnp.int32(0)}, host, cell["steps"], "single/",
            out)
        step, state_sh, bsh = build_train_step(plan, mesh, optimizer=opt)
        params = jax.device_put(host_params(), state_sh["params"])
        state = {"params": params,
                 "opt": jax.device_put(opt.init(params), state_sh["opt"]),
                 "step": jax.device_put(jnp.int32(0), state_sh["step"])}
        state = run(step, state, jax.device_put(host, bsh(host)),
                    cell["steps"], "", out)
        for part, tree, sh in (("params", state["params"],
                                state_sh["params"]),
                               ("m", state["opt"].m, state_sh["opt"].m),
                               ("v", state["opt"].v, state_sh["opt"].v)):
            shardings = flat(sh)
            for path, a in flat(tree).items():
                out[f"shape/{part}/{path}"] = np.array(
                    shardings[path].shard_shape(a.shape))
        np.savez(Path(d) / f"{name}_jax.npz", **out)


# ---------------------------------------------------------------------------
# The port's rank program
# ---------------------------------------------------------------------------


def port_plan(cell):
    from repro_torch.core.hardware import MeshSpec
    from repro_torch.core.lm_planner import plan_lm

    cfg = cell_config(cell)
    plan = plan_lm(cfg, "train_4k", MeshSpec(tuple(zip(MESH[1], MESH[0]))))
    return _cell_plan(dataclasses.replace(plan, cfg=cfg,
                                          microbatches=MICROBATCHES), cell)


def port_state(d, name, optimizer, device="cpu"):
    """The cell's initial global state in the port, on ``device``."""

    import torch

    from repro_torch.carry import lm_params_from_numpy

    params = lm_params_from_numpy(cell_config(CELLS[name]),
                                  nest(load(d, name, "params")),
                                  device=device)
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.tensor(0, dtype=torch.int32, device=device)}


def digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


class _Audit:
    """Records every index the rank's layers hand to torch at the two
    sites that compute one from a global id: the vocab-parallel lookup
    and loss (``lm._vocab_local``; a tied table's too) and the MoE
    dispatch's buffer rows (``blocks._local_slots``), counted by cell and
    site."""

    def __init__(self):
        self.checked, self.bad = 0, []
        self.cell, self.sites = None, {}

    def patches(self):
        from unittest import mock

        from repro_torch.models import blocks, lm

        real_vocab, real_slots = lm._vocab_local, blocks._local_slots

        def vocab_local(ids, n):
            local, inside = real_vocab(ids, n)
            self._check("vocab", local, n - 1)
            return local, inside

        def local_slots(e_s, rank, keep, x0, n_local, cap):
            slot, mine = real_slots(e_s, rank, keep, x0, n_local, cap)
            self._check("slots", slot, n_local * cap)
            return slot, mine

        return (mock.patch.object(lm, "_vocab_local", vocab_local),
                mock.patch.object(blocks, "_local_slots", local_slots))

    def _check(self, site, idx, hi):
        self.checked += 1
        key = f"{self.cell}/{site}"
        self.sites[key] = self.sites.get(key, 0) + 1
        lo_, hi_ = int(idx.min()), int(idx.max())
        if lo_ < 0 or hi_ > hi:
            self.bad.append((site, lo_, hi_, hi))


def final_state(state):
    """``{part/path: numpy array}`` of a global state's params and
    moments."""

    out = {}
    for part, tree in (("params", state["params"]), ("m", state["opt"].m),
                       ("v", state["opt"].v)):
        for path, t in flat(tree).items():
            out[f"{part}/{path}"] = t.detach().cpu().numpy().copy()
    return out


def run_single(d, name):
    """The cell through the port's one-device step: losses, grad norms and
    the final state."""

    from repro_torch.launch import train
    from repro_torch.optim import adamw

    cell = CELLS[name]
    opt = adamw(lr=LR)
    step, _, _ = train.build_train_step(port_plan(cell), None, optimizer=opt,
                                        device="cpu")
    state = port_state(d, name, opt)
    batch = load(d, name, "batch")
    losses, norms = [], []
    for _ in range(cell["steps"]):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return {"losses": losses, "grad_norms": norms,
            "final": final_state(state)}


def run_cell(d, name, mesh, audit=None):
    """One cell on this rank: losses, grad norms, the last step's
    collectives by phase, the local block shapes, the gathered final
    state (numpy) and its digest."""

    import contextlib

    from repro_torch.carry import gather_state, shard_state
    from repro_torch.launch import train
    from repro_torch.optim import adamw

    cell = CELLS[name]
    opt = adamw(lr=LR)
    step, specs, batch_fn = train.build_train_step(port_plan(cell), mesh,
                                                   optimizer=opt)
    state = shard_state(port_state(d, name, opt), specs, mesh)
    rows = batch_fn(load(d, name, "batch"))
    shapes = {}
    for part, tree in (("params", state["params"]), ("m", state["opt"].m),
                       ("v", state["opt"].v)):
        for path, t in flat(tree).items():
            shapes[f"{part}/{path}"] = tuple(t.shape)
    losses, norms, phases = [], [], []
    with contextlib.ExitStack() as stack:
        if audit is not None:
            audit.cell = name
            for p in audit.patches():
                stack.enter_context(p)
        for _ in range(cell["steps"]):
            state, metrics = step(state, rows)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            phases.append(step.phases)
    full = gather_state(state, specs, mesh)
    final = final_state(full)
    return {"losses": losses, "grad_norms": norms, "phases": phases,
            "shapes": shapes, "final": final,
            "digest": digest(final[k] for k in sorted(final)),
            "step": int(full["step"])}


def _backward_in_a_thread():
    """Every ``Tensor.backward`` run in a fresh thread, whose context
    variables are unset, as autograd's device thread runs a CUDA backward
    (and the recompute of its checkpoints)."""

    import threading
    from unittest import mock

    import torch

    real = torch.Tensor.backward

    def backward(self, *args, **kwargs):
        box = []

        def run():
            try:
                real(self, *args, **kwargs)
            except BaseException as err:      # raised in the caller below
                box.append(err)

        t = threading.Thread(target=run)
        t.start()
        t.join()
        if box:
            raise box[0]

    return mock.patch.object(torch.Tensor, "backward", backward)


def rank_main(rank, world, d):
    """One of 8 ranks: every cell, then the ZeRO-3 masked cell again with
    every backward in another thread (two runs bit-identical, and the
    backward's collectives and recompute bound to the mesh as on the
    card), the C1 audit running throughout.  Rank 0 returns the final
    states; every rank returns its numbers and digests."""

    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(*MESH, device="cpu")
    audit = _Audit()
    out = {}
    for name in CELLS:
        out[name] = run_cell(d, name, mesh, audit)
    with _backward_in_a_thread():
        again = run_cell(d, AGAIN, mesh)
    out["again_digest"] = again["digest"]
    out["again_losses"] = again["losses"]
    out["audit"] = {"checked": audit.checked, "bad": audit.bad,
                    "sites": audit.sites}
    if rank:
        for name in CELLS:
            del out[name]["final"]
    return out


def out_of_step(rank, world):
    """Two ranks out of lockstep: rank 1 leaves before the step that rank
    0 runs, so rank 0's first collective has no partner."""

    import torch

    from repro_torch.carry import shard_state
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.optim import adamw

    mesh = make_mesh((2,), ("model",), device="cpu")
    if rank == 1:
        return None
    plan = dataclasses.replace(port_plan(CELLS["zero1"]), microbatches=1)
    opt = adamw(lr=LR)
    step, specs, batch_fn = train.build_train_step(plan, mesh, optimizer=opt)
    params = lm.init_params(plan.cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    state = shard_state({"params": params, "opt": opt.init(params),
                         "step": torch.tensor(0, dtype=torch.int32)},
                        specs, mesh)
    step(state, batch_fn({"tokens": np.zeros((2, 8), np.int32)}))
    return "stepped"


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    jax_main(sys.argv[1])
