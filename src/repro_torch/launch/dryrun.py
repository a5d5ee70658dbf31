"""One-device dry run: count every (architecture x shape) cell's step on
the ``meta`` device and record the roofline inputs (the JAX package's
``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch phi4_mini_3_8b \\
        --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # all cells

A cell plans with :func:`~repro_torch.core.lm_planner.plan_lm` on a
one-device mesh with ``hw=H100_SXM``, builds its step through the port's
own entry points (``launch.train.build_train_step``,
``launch.serve.build_prefill_step`` / ``build_decode_step``) with
``device="meta"`` on :func:`~repro_torch.models.registry.abstract_params`
and :func:`~repro_torch.models.registry.input_specs`, runs it once under
:func:`~repro_torch.launch.census.census_of` and writes the JAX artifact's
keys: ``plan``, ``memory``, ``cost``, ``collectives`` and ``roofline`` (on
``H100_SXM``).  The ``meta`` device is the design, as the JAX package's
placeholder CPU devices are: it needs no card and no ``XLA_FLAGS``, and a
full-width cell costs host time only.

Where the artifact differs from the JAX package's:

* ``memory`` comes from the census's storage tracking: argument, output
  and alias bytes of the step's arguments and result, ``peak_hbm_estimate``
  the tracked peak, and ``temp_bytes`` what the peak holds beyond the
  arguments and the new outputs;
* ``cost`` holds ``flops_per_device`` and ``bytes_per_device``; XLA's
  uncorrected cost (``xla_flops_uncorrected``, ``xla_bytes_uncorrected``)
  and ``while_trips`` have no counterpart in an eager run and are left out;
* ``timings`` holds the census's wall time (``census_s``), where the JAX
  package's holds its lower and compile times;
* ``--mesh`` takes ``one`` (the default, the ``mesh=None`` branch of both
  packages' step builders); the JAX package's ``single`` and ``multi``
  meshes (256 and 512 devices) raise ``NotImplementedError``: meshes are
  ROADMAP A10e;
* ``--save-hlo`` is gone: there is no HLO.

``--all`` spawns one subprocess per cell and skips cells whose artifact
already exists (``--force`` redoes them).  Artifacts land in
``artifacts/dryrun_torch/<cell>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional

__all__ = ["ARTIFACT_DIR", "MESH_KINDS", "run_cell", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
ARTIFACT_DIR = os.path.join(_ROOT, "artifacts", "dryrun_torch")
# "one": one device; the JAX package's production meshes, not ported yet.
MESH_KINDS = {"one": 1, "single": 256, "multi": 512}


def _cell_name(arch: str, shape: str, mesh: str, variant: str = "") -> str:
    v = f"__{variant}" if variant else ""
    return f"{arch}__{shape}__{mesh}{v}"


def _step_and_args(plan, shape: str):
    """The cell's step, built by the port's entry points on ``meta``, and
    its arguments."""

    import torch

    from repro_torch.launch import serve as serve_mod
    from repro_torch.launch import train as train_mod
    from repro_torch.models.common import SHAPES
    from repro_torch.models.registry import abstract_params, input_specs

    meta = torch.device("meta")
    cfg = plan.cfg
    params = abstract_params(cfg)
    specs = input_specs(cfg, shape)
    if plan.kind == "train":
        step, _, _ = train_mod.build_train_step(plan, None, device=meta)
        state = {
            "params": params,
            "opt": train_mod.make_optimizer(plan).init(params),
            "step": torch.zeros((), dtype=torch.int32, device=meta),
        }
        return step, (state, specs)
    if plan.kind == "prefill":
        step, _ = serve_mod.build_prefill_step(plan, None,
                                               SHAPES[shape]["seq"], meta)
        return step, (params, specs)
    step, _, _ = serve_mod.build_decode_step(plan, None, meta)
    return step, (params, specs["cache"], specs["token"], specs["pos"])


def run_cell(arch: str, shape: str, mesh_kind: str = "one",
             variant: str = "", overrides: Optional[Dict] = None
             ) -> Dict[str, Any]:
    """Count one cell in-process and return the artifact dict."""

    from repro_torch.core.hardware import H100_SXM, MeshSpec
    from repro_torch.core.lm_planner import plan_lm
    from repro_torch.launch.census import census_of, roofline_terms
    from repro_torch.models.registry import cell_is_applicable, get_config

    t0 = time.time()
    cfg = get_config(arch)
    ok, why = cell_is_applicable(cfg, shape)
    name = _cell_name(arch, shape, mesh_kind, variant)
    if not ok:
        return {"cell": name, "status": "skipped", "reason": why,
                "arch": arch, "shape": shape, "mesh": mesh_kind,
                "variant": variant}
    if mesh_kind not in MESH_KINDS:
        raise ValueError(f"mesh must be one of {sorted(MESH_KINDS)}, got "
                         f"{mesh_kind!r}")
    if mesh_kind != "one":
        raise NotImplementedError(
            f"the {mesh_kind!r} mesh ({MESH_KINDS[mesh_kind]} devices) is "
            f"not ported yet (ROADMAP A10e); the port's dry run takes mesh "
            f"'one'")

    mesh_spec = MeshSpec((("data", 1),))
    plan = plan_lm(cfg, shape, mesh_spec, hw=H100_SXM, overrides=overrides)
    step, args = _step_and_args(plan, shape)
    _, census = census_of(step, *args)
    terms = roofline_terms(census, mesh_spec.n_devices, hw=H100_SXM)
    new_bytes = census.output_bytes - census.alias_bytes
    return {
        "cell": name,
        "status": "ok",
        "arch": arch,
        "shape": shape,
        "mesh": mesh_kind,
        "variant": variant,
        "kind": plan.kind,
        "n_devices": mesh_spec.n_devices,
        "hardware": H100_SXM.name,
        "plan": {
            "zero": plan.zero,
            "fsdp": plan.rules.fsdp,
            "expert_parallel": plan.rules.expert_parallel,
            "remat": plan.remat,
            "microbatches": plan.microbatches,
            "param_dtype": plan.cfg.param_dtype,
            "m_dtype": plan.m_dtype,
            "v_dtype": plan.v_dtype,
            "notes": list(plan.notes),
        },
        "memory": {
            "argument_bytes": census.argument_bytes,
            "output_bytes": census.output_bytes,
            "temp_bytes": (census.peak_bytes - census.argument_bytes
                           - new_bytes),
            "alias_bytes": census.alias_bytes,
            "peak_hbm_estimate": census.peak_bytes,
        },
        "cost": {
            "flops_per_device": census.dot_flops,
            "bytes_per_device": census.bytes_accessed,
        },
        "collectives": {
            "by_type_bytes": census.by_type_bytes,
            "by_type_count": census.by_type_count,
            "ici_link_bytes": census.ici_link_bytes,
            "dcn_link_bytes": census.dcn_link_bytes,
            "total_operand_bytes": census.total_operand_bytes,
        },
        "roofline": terms,
        "timings": {"census_s": time.time() - t0},
    }


def _save(artifact: Dict[str, Any]) -> str:
    os.makedirs(ARTIFACT_DIR, exist_ok=True)
    path = os.path.join(ARTIFACT_DIR, artifact["cell"] + ".json")
    with open(path, "w") as f:
        json.dump(artifact, f, indent=1, default=float)
    return path


def _run_all(mesh_kinds, force: bool) -> int:
    from repro_torch.models.common import SHAPES
    from repro_torch.models.registry import ARCH_IDS

    failures = 0
    cells = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in mesh_kinds]
    t_all = time.time()
    for arch, shape, mesh_kind in cells:
        name = _cell_name(arch, shape, mesh_kind)
        out = os.path.join(ARTIFACT_DIR, name + ".json")
        if os.path.exists(out) and not force:
            print(f"[skip cached] {name}")
            continue
        print(f"[run] {name}", flush=True)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--arch", arch, "--shape", shape, "--mesh", mesh_kind],
            capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": os.path.join(_ROOT, "src")},
            cwd=_ROOT,
        )
        dt = time.time() - t0
        if proc.returncode != 0:
            failures += 1
            print(f"[FAIL {dt:.0f}s] {name}\n{proc.stdout[-2000:]}"
                  f"\n{proc.stderr[-4000:]}")
            os.makedirs(ARTIFACT_DIR, exist_ok=True)
            with open(os.path.join(ARTIFACT_DIR, name + ".err.txt"),
                      "w") as f:
                f.write(proc.stdout + "\n" + proc.stderr)
        else:
            print(f"[ok {dt:.0f}s] {name}: {proc.stdout.splitlines()[0]}",
                  flush=True)
    print(f"all cells in {time.time() - t_all:.0f}s, {failures} failed")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=(*MESH_KINDS, "both"), default="one",
                    help="one device (the port's); 'single', 'multi' and "
                         "'both' (the JAX package's meshes) wait for "
                         "ROADMAP A10e")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="")
    ap.add_argument("--override", action="append", default=[],
                    help="plan override key=value (e.g. microbatches=4)")
    args = ap.parse_args(argv)

    mesh_kinds = (
        ("single", "multi") if args.mesh == "both" else (args.mesh,)
    )
    if args.all:
        return 1 if _run_all(mesh_kinds, args.force) else 0
    if not (args.arch and args.shape):
        ap.error("--arch and --shape are needed without --all")

    overrides: Dict[str, Any] = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v

    artifact = run_cell(args.arch, args.shape, mesh_kinds[0],
                        variant=args.variant, overrides=overrides or None)
    path = _save(artifact)
    if artifact["status"] != "ok":
        print(f"cell={artifact['cell']} SKIPPED: {artifact['reason']}")
        return 0
    r, mem, cost = (artifact["roofline"], artifact["memory"],
                    artifact["cost"])
    print(f"cell={artifact['cell']} on {artifact['hardware']}: "
          f"flops={cost['flops_per_device']:.4e} "
          f"bytes={cost['bytes_per_device']:.4e} "
          f"peak~{mem['peak_hbm_estimate'] / 2**30:.2f}GiB "
          f"in {artifact['timings']['census_s']:.1f}s")
    print(f"  memory/device: args={mem['argument_bytes'] / 2**30:.2f}GiB "
          f"temp={mem['temp_bytes'] / 2**30:.2f}GiB "
          f"peak~{mem['peak_hbm_estimate'] / 2**30:.2f}GiB")
    print(f"  roofline: compute={r['compute_s'] * 1e3:.3f}ms "
          f"memory={r['memory_s'] * 1e3:.3f}ms "
          f"collective={r['collective_s'] * 1e3:.3f}ms "
          f"dominant={r['dominant']}")
    print(f"  artifact: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
