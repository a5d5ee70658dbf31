"""LM prefill and decode on a ``(data, model)`` mesh, in both packages:
shared inputs, the JAX package's 8-device program and the port's rank
program of ``test_torch_spmd_serve_lm.py``.

The cells (``CELLS``), each a prompt of ``PROMPT`` tokens, greedy decode
from the prefill's last logits:

* ``minitron`` — reduced minitron-8b on ``(data 4, model 2)``,
  ``cache_len`` 32 (16 slots a ``model`` rank), 8 steps;
* ``mixtral_ring`` — reduced mixtral-8x22b (MoE, EP over ``model``,
  window 16): a cache of 16 slots, shorter than the prompt, so prefill
  rolls the prompt's last 16 positions into the ring and 12 decode steps
  wrap it (the written slot moves from ``model`` rank 1's block to rank
  0's);
* ``arctic_whole`` — reduced arctic-480b (MoE with the dense residual)
  under ZeRO-3 (``rules.fsdp``, gathered at use), ``cache_len`` 33: the
  divisibility filter keeps the slots whole on every rank;
* ``minitron_pod`` — the first cell on ``(pod 2, data 2, model 2)``;
* ``minitron_heads_whole`` — the same model on ``(data 2, model 3)``
  over ranks 0-5: 3 divides neither its 4 heads (the planner replicates
  the attention), its ffn nor its vocab, but divides a ``cache_len`` of
  33, so the slots alone are cut (11 a rank) and decode joins the split
  softmax of whole heads;
* ``minicpm3`` — reduced minicpm3-4b (MLA) on ``(data 4, model 2)``,
  ``cache_len`` 32: the latent cache's slots cut over ``model``, decode's
  split softmax joined in the latent space (A10h-1);
* ``whisper`` — reduced whisper-medium on ``(data 4, model 2)`` with
  its published vocab of 51,865 (padded to 51,968: the last ``model``
  rank's block ends in 103 padded columns), ``cache_len`` 32 and
  ``enc_input`` frames; the cross K/V cache whole over ``model`` (A10h-1);
* ``mamba2`` — reduced mamba2-130m on ``(data 4, model 2)`` with its
  published vocab of 50,280 (padded to 50,432, so the prompt's tokens
  fall in both ``model`` ranks' blocks of the tied table): the SSD mixer
  whole on every ``model`` rank, its ``conv`` window and state cut over
  ``batch`` only and carried through 8 decode steps, the tied table as
  the vocab-parallel lookup and head (A10h-2);
* ``hymba_ring`` — reduced hymba-1.5b with 5 q / 1 kv heads (hymba's
  published 25 / 5 ratio, ``config``) and its published vocab of 32,001
  (padded to 32,256: 255 padded columns on the last ``model`` rank) on
  ``(data 4, model 2)``: 2 divides neither head count, so the planner
  keeps ``qkv`` whole and every rank attends every head, as the
  reference (A10h-3, case (ii)); a 16-slot ring, shorter than the
  prompt, cut over ``model``, which 12 decode steps wrap, decode joining
  the split softmax of the whole heads; the SSM half's cache whole over
  ``model`` (A10h-2);
* ``minitron_kv`` — reduced minitron-8b as it is (4 q / 2 kv heads) on
  ``(data 2, model 4)``: 4 divides the q heads, not the kv heads, which
  are gathered whole and repeated to the rank's q head (A10h-3, case
  (i)); its padded vocab fills the last two ``model`` ranks' blocks;
* ``minitron_kv_whole`` — the same with ``cache_len`` 33, which 4 does
  not divide: the slots whole, so decode repeats the whole cache's kv
  heads to the rank's q head.

The plans are the planner's ``prefill_32k`` / ``decode_32k`` plans for the
mesh (the arctic cell's ZeRO-3 set on both).  The weights and prompts are
numpy arrays made from a seed (:func:`make_inputs`, ``.npz`` files in a
directory): the JAX program (``python _spmd_serve_lm_workloads.py DIR``,
8 virtual devices) and the 8 ``gloo`` ranks (:func:`rank_main`) read the
same files.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np

from _spmd_train_workloads import _init_leaf, digest, flat, nest, port_config

MESHES = {"dm": ((4, 2), ("data", "model")),
          "pdm": ((2, 2, 2), ("pod", "data", "model")),
          "dm3": ((2, 3), ("data", "model")),
          "dm4": ((2, 4), ("data", "model"))}
CELLS = {
    "minitron": {"arch": "minitron_8b", "mesh": "dm", "cache_len": 32,
                 "steps": 8, "fsdp": False},
    "mixtral_ring": {"arch": "mixtral_8x22b", "mesh": "dm", "cache_len": 16,
                     "steps": 12, "fsdp": False},
    "arctic_whole": {"arch": "arctic_480b", "mesh": "dm", "cache_len": 33,
                     "steps": 8, "fsdp": True},
    "minitron_pod": {"arch": "minitron_8b", "mesh": "pdm", "cache_len": 32,
                     "steps": 8, "fsdp": False},
    "minitron_heads_whole": {"arch": "minitron_8b", "mesh": "dm3",
                             "cache_len": 33, "steps": 8, "fsdp": False},
    "minicpm3": {"arch": "minicpm3_4b", "mesh": "dm", "cache_len": 32,
                 "steps": 8, "fsdp": False},
    "whisper": {"arch": "whisper_medium", "mesh": "dm", "cache_len": 32,
                "steps": 8, "fsdp": False, "vocab": 51865},
    "mamba2": {"arch": "mamba2_130m", "mesh": "dm", "cache_len": 32,
               "steps": 8, "fsdp": False, "vocab": 50280},
    "hymba_ring": {"arch": "hymba_1_5b", "mesh": "dm", "cache_len": 16,
                   "steps": 12, "fsdp": False, "vocab": 32001,
                   "config": {"n_heads": 5, "n_kv_heads": 1}},
    "minitron_kv": {"arch": "minitron_8b", "mesh": "dm4", "cache_len": 32,
                    "steps": 8, "fsdp": False},
    "minitron_kv_whole": {"arch": "minitron_8b", "mesh": "dm4",
                          "cache_len": 33, "steps": 8, "fsdp": False},
}
PROMPT = (8, 24)
SEED = 0
# The cell run twice on every rank (bit-identical).
AGAIN = "minitron"


def cell_config(cell):
    """The cell's reduced config in the port (its ``vocab`` and its
    ``config`` overrides where the cell sets them, as the JAX program
    does)."""

    cfg = dataclasses.replace(port_config(cell["arch"]),
                              **cell.get("config", {}))
    if "vocab" in cell:
        cfg = dataclasses.replace(cfg, vocab=cell["vocab"])
    return cfg


def make_inputs(d):
    """Write each cell's weights (``{cell}_params.npz``) and prompt
    (``{cell}_tokens.npy``) to ``d``, from ``SEED``."""

    from repro_torch.models import lm

    for i, (name, cell) in enumerate(CELLS.items()):
        cfg = cell_config(cell)
        rng = np.random.default_rng([SEED, 100 + i])
        params = {}
        for k, sub in lm.model_specs(cfg).items():
            stacked = lm.n_stack(cfg, k)
            for path, spec in flat(sub, f"{k}/").items():
                params[path] = _init_leaf(spec, stacked, cfg.n_layers, rng)
        np.savez(Path(d) / f"{name}_params.npz", **params)
        np.save(Path(d) / f"{name}_tokens.npy",
                rng.integers(0, cfg.vocab, PROMPT).astype(np.int32))
        if cfg.family == "encdec":
            np.save(Path(d) / f"{name}_frames.npy", rng.standard_normal(
                (PROMPT[0], cfg.enc_seq, cfg.d_model)).astype(np.float32))


def load_batch(d, name):
    """The cell's prompt batch: its tokens, and an encoder-decoder's
    frames."""

    batch = {"tokens": np.load(Path(d) / f"{name}_tokens.npy")}
    frames = Path(d) / f"{name}_frames.npy"
    if frames.exists():
        batch["enc_input"] = np.load(frames)
    return batch


def load_params(d, name):
    with np.load(Path(d) / f"{name}_params.npz") as f:
        return nest({k: f[k] for k in f.files})


def _plans(plan_lm, MeshSpec, cfg, cell):
    shape, axes = MESHES[cell["mesh"]]
    out = []
    for kind in ("prefill_32k", "decode_32k"):
        plan = dataclasses.replace(
            plan_lm(cfg, kind, MeshSpec(tuple(zip(axes, shape)))), cfg=cfg)
        if cell["fsdp"]:
            plan = dataclasses.replace(
                plan, rules=dataclasses.replace(plan.rules, fsdp=True))
        out.append(plan)
    return out


# ---------------------------------------------------------------------------
# The JAX package on 8 virtual devices (run as a program)
# ---------------------------------------------------------------------------


def jax_main(d):
    """Every cell through the reference's ``build_prefill_step`` /
    ``build_decode_step`` on its mesh of 8 virtual devices (the cache put
    at ``cache_shardings`` for decode) and on one device; writes
    ``{cell}_jax.npz``: each step's logits and the greedy tokens, the
    caches after prefill and after decode, and every cache leaf's shard
    shape (one-device results under ``single/``)."""

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding

    from repro.core.hardware import MeshSpec
    from repro.core.lm_planner import plan_lm
    from repro.launch.serve import (build_decode_step, build_prefill_step,
                                    greedy_sample)
    from repro.models.registry import get_config, reduced_config
    from repro.parallel import logical_to_spec

    def serve(prefill_fn, decode_fn, p_params, d_params, batch, put_cache,
              steps, L, tag, out):
        logits, cache, pos = prefill_fn(p_params, batch)
        cache = put_cache(cache)
        for path, a in flat(cache).items():
            out[f"{tag}cache0/{path}"] = np.asarray(a, np.float32)
        got, toks = [np.asarray(logits[:, -1], np.float32)], []
        token = greedy_sample(logits)
        for i in range(steps):
            toks.append(np.asarray(token))
            logits, cache = decode_fn(d_params, cache, token, pos + i)
            got.append(np.asarray(logits[:, -1], np.float32))
            token = greedy_sample(logits)
        toks.append(np.asarray(token))
        out[f"{tag}logits"] = np.stack(got)
        out[f"{tag}tokens"] = np.concatenate(toks, axis=1)
        for path, a in flat(cache).items():
            out[f"{tag}cache1/{path}"] = np.asarray(a, np.float32)

    for name, cell in CELLS.items():
        cfg = dataclasses.replace(reduced_config(get_config(cell["arch"])),
                                  **cell.get("config", {}))
        if "vocab" in cell:
            cfg = dataclasses.replace(cfg, vocab=cell["vocab"])
        pplan, dplan = _plans(plan_lm, MeshSpec, cfg, cell)
        L, steps = cell["cache_len"], cell["steps"]
        host = {k: jnp.asarray(v) for k, v in load_batch(d, name).items()}

        def params():
            return jax.tree_util.tree_map(jnp.asarray, load_params(d, name))

        out = {}
        prefill_fn, _ = build_prefill_step(pplan, None, L)
        decode_fn, _, _ = build_decode_step(dplan, None)
        one = params()
        serve(prefill_fn, decode_fn, one, one, host, lambda c: c, steps, L,
              "single/", out)
        shape, axes = MESHES[cell["mesh"]]
        mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))])
                    .reshape(shape), axes)
        prefill_fn, p_sh = build_prefill_step(pplan, mesh, L)
        decode_fn, d_sh, c_sh = build_decode_step(dplan, mesh)
        rows = {k: NamedSharding(mesh, logical_to_spec(
            pplan.rules, ("batch",) + (None,) * (v.ndim - 1), shape=v.shape,
            mesh=mesh)) for k, v in host.items()}
        cache_sh = c_sh(PROMPT[0], L)
        serve(prefill_fn, decode_fn, jax.device_put(params(), p_sh),
              jax.device_put(params(), d_sh), jax.device_put(host, rows),
              lambda c: jax.device_put(c, cache_sh), steps, L, "", out)
        for path, sh in flat(cache_sh).items():
            out[f"shape/{path}"] = np.array(sh.shard_shape(
                out[f"cache1/{path}"].shape))
        np.savez(Path(d) / f"{name}_jax.npz", **out)


# ---------------------------------------------------------------------------
# The port's rank program
# ---------------------------------------------------------------------------


def port_plans(cell):
    from repro_torch.core.hardware import MeshSpec
    from repro_torch.core.lm_planner import plan_lm

    return _plans(plan_lm, MeshSpec, cell_config(cell), cell)


class _Audit:
    """Records, inside the rank, every index the serve path computes from
    a global one (ROADMAP C1): the decode's local slot write
    (``blocks._local_slot``: the owner alone writes, inside its block),
    the mask's global slot ids (``blocks._slot_valid``: inside the
    cache), the vocab-parallel lookup's local ids (``lm._vocab_local``)
    and the vocab-parallel argmax's tokens (inside the real vocab)."""

    def __init__(self):
        self.checked, self.bad, self.writes = 0, [], 0
        self.cell, self.sites = None, {}

    def patches(self, cfg):
        from unittest import mock

        from repro_torch.launch import serve
        from repro_torch.models import blocks, lm

        real_slot, real_valid = blocks._local_slot, blocks._slot_valid
        real_vocab, real_sample = lm._vocab_local, serve.greedy_sample

        def local_slot(slot, first, n):
            local = real_slot(slot, first, n)
            if local is not None:
                self.writes += 1
                self._check("write", local, local, n - 1)
            return local

        def slot_valid(pos, L, window, slots):
            self._check("mask", int(slots.min()), int(slots.max()), L - 1)
            return real_valid(pos, L, window, slots)

        def vocab_local(ids, n):
            local, inside = real_vocab(ids, n)
            self._check("vocab", int(local.min()), int(local.max()), n - 1)
            return local, inside

        def sample(logits, *args):
            token = real_sample(logits, *args)
            self._check("argmax", int(token.min()), int(token.max()),
                        cfg.vocab - 1)
            return token

        return (mock.patch.object(blocks, "_local_slot", local_slot),
                mock.patch.object(blocks, "_slot_valid", slot_valid),
                mock.patch.object(lm, "_vocab_local", vocab_local),
                mock.patch.object(serve, "greedy_sample", sample))

    def _check(self, site, lo, hi, top):
        self.checked += 1
        key = f"{self.cell}/{site}"
        self.sites[key] = self.sites.get(key, 0) + 1
        if lo < 0 or hi > top:
            self.bad.append((site, lo, hi, top))


def _padded_block(logits, cfg, mesh):
    """(padded columns in this rank's vocab block, whether all are
    -1e30) of the last position's logits."""

    import torch

    n = logits.shape[-1]
    first = mesh.coordinate("model") * n if n < cfg.padded_vocab else 0
    pad = logits[:, -1, max(cfg.vocab - first, 0):]
    return int(pad.shape[-1]), bool(torch.all(pad == -1e30))


def run_cell(d, name, mesh, audit=None):
    """One cell on this rank: the joined logits of prefill and each step,
    the greedy tokens (joined, and this rank's rows), the joined caches
    after prefill and after decode, each cache block's shape, the padded
    columns of the rank's vocab block, and a digest of it all."""

    import contextlib

    import torch

    from repro_torch.carry import gather_cache, lm_params_from_numpy, \
        shard_cache, shard_state
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import join_blocks, logical_to_spec

    cell = CELLS[name]
    cfg = cell_config(cell)
    pplan, dplan = port_plans(cell)
    L, steps, B = cell["cache_len"], cell["steps"], PROMPT[0]
    params = lm_params_from_numpy(cfg, load_params(d, name), device="cpu")
    with contextlib.ExitStack() as stack:
        if audit is not None:
            audit.cell = name
            for p in audit.patches(cfg):
                stack.enter_context(p)
        prefill_fn, p_specs = serve.build_prefill_step(pplan, mesh, L)
        decode_fn, d_specs, c_specs = serve.build_decode_step(
            dplan, mesh, cache_len=L)
        p_blocks = shard_state(params, p_specs, mesh)
        d_blocks = shard_state(params, d_specs, mesh)
        rows = serve.batch_rows(load_batch(d, name), mesh, pplan.rules)
        specs = c_specs(B, L)
        logits, cache, pos = prefill_fn(p_blocks, rows)
        shapes = {k: tuple(t.shape) for k, t in flat(cache).items()}
        cache0 = flat(gather_cache(cache, specs, mesh))
        # the joined cache cut again, and a zero cache made on the mesh
        again = flat(shard_cache(nest(cache0), specs, mesh))
        zeros = flat(lm.init_cache(cfg, B, L, mesh=mesh, rules=dplan.rules))
        carried = all(torch.equal(again[k], t) and t.dtype == zeros[k].dtype
                      and t.shape == zeros[k].shape
                      and not bool(zeros[k].any())
                      for k, t in flat(cache).items())
        got, toks, pads = [], [], []
        token = serve.greedy_sample(logits, cfg, mesh)
        for i in range(steps + 1):
            got.append(lm.gather_logits(logits, cfg, mesh, dplan.rules,
                                        B)[:, -1].numpy())
            pads.append(_padded_block(logits, cfg, mesh))
            toks.append(token)
            if i == steps:
                break
            logits, cache = decode_fn(d_blocks, cache, token, pos + i)
            token = serve.greedy_sample(logits, cfg, mesh)
    local = torch.cat(toks, dim=1)
    spec = logical_to_spec(dplan.rules, ("batch", None), shape=(B, 1),
                           mesh=mesh)
    tokens = join_blocks(local, spec, mesh).numpy()
    cache1 = flat(gather_cache(cache, specs, mesh))
    blocks = [t.numpy() for _, t in sorted(flat(cache).items())]
    out = {"logits": np.stack(got), "tokens": tokens,
           "local_tokens": local.numpy(), "cache0": cache0,
           "cache1": cache1, "shapes": shapes, "pads": pads,
           "block_digest": digest(blocks), "carried": carried,
           "model": mesh.coordinate("model"), "tp": mesh.shape["model"],
           "rows": mesh.linear_index(mesh.batch_axes)}
    out["digest"] = digest([out["logits"], tokens]
                           + [cache0[k] for k in sorted(cache0)]
                           + [cache1[k] for k in sorted(cache1)])
    return out


def rank_main(rank, world, d):
    """One of 8 ranks: every cell on its mesh with the C1 audit running
    (a cell whose mesh leaves the rank out gives ``None``), then ``AGAIN``
    a second time; rank 0 returns the joined arrays, every rank its
    digests, rows, block shapes and padded columns."""

    import math

    from repro_torch.launch.mesh import make_mesh

    meshes = {k: make_mesh(shape, axes, device="cpu",
                           ranks=None if math.prod(shape) == world
                           else list(range(math.prod(shape))))
              for k, (shape, axes) in MESHES.items()}
    audit = _Audit()
    out = {}
    for name, cell in CELLS.items():
        mesh = meshes[cell["mesh"]]
        out[name] = None if mesh is None else run_cell(d, name, mesh, audit)
    again = run_cell(d, AGAIN, meshes[CELLS[AGAIN]["mesh"]])
    out["again_digest"] = again["digest"]
    out["audit"] = {"checked": audit.checked, "bad": audit.bad,
                    "writes": audit.writes, "sites": audit.sites}
    if rank:
        for name in CELLS:
            for k in ("logits", "tokens", "cache0", "cache1"):
                if out[name] is not None:
                    del out[name][k]
    return out


if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    jax_main(sys.argv[1])
