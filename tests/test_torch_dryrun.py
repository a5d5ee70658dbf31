"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's (``repro.launch.dryrun``), on the CPU.

* Prefill and decode: for the reduced config of each of the ten
  architectures, the census's dot FLOPs of the port's steps, built by its
  entry points on the ``meta`` device, equal ``analyze_hlo``'s of the JAX
  package's ``mesh=None`` steps exactly (training:
  ``test_torch_dryrun_train.py``).
* ``abstract_params`` / ``abstract_cache`` match ``init_params`` /
  ``init_cache`` leaf by leaf, and the JAX package's abstract trees at full
  width; ``cell_is_applicable`` and ``input_specs`` match the JAX
  package's on all 40 cells.
* The argument bytes are the real state's and batch's; the artifact holds
  the JAX artifact's keys; the JAX package's meshes raise naming A10.
"""

import ast
import json
from pathlib import Path

import pytest
import torch

import repro.launch.hlo_analysis as jax_hlo_analysis
from repro.models import lm as jax_lm
from repro.models import registry as jax_registry
from repro_torch.core.lm_planner import plan_lm
from repro_torch.core.hardware import H100_SXM, MeshSpec
from repro_torch.core.tree import tree_leaves
from repro_torch.launch import dryrun
from repro_torch.launch.train import make_optimizer
from repro_torch.models import lm
from repro_torch.models import registry
from repro_torch.models.common import SHAPES, dtype_of

from _dryrun_cells import (
    BATCH,
    TINY,
    jax_dot_flops,
    port_cell,
    use_tiny_cells,
)


@pytest.mark.parametrize("shape", ["tiny_prefill", "tiny_decode"])
@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_serving_flops_equal_the_jax_census(arch, shape, monkeypatch):
    use_tiny_cells(monkeypatch)
    art = port_cell(arch, shape)
    assert art["status"] == "ok" and art["kind"] == TINY[shape]["kind"]
    assert art["cost"]["flops_per_device"] == jax_dot_flops(arch, shape)


def _shapes(tree, path=""):
    """``{path: (shape, dtype)}`` of a nested dict of tensors or of JAX's
    ShapeDtypeStructs."""

    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _shapes(sub, f"{path}/{k}").items()}
    return {path: (tuple(tree.shape),
                   str(tree.dtype).replace("torch.", ""))}


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_abstract_trees_match_init_and_the_jax_package(arch):
    full = registry.get_config(arch)
    cfg = registry.reduced_config(full)
    gen = torch.Generator().manual_seed(0)
    abstract = registry.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in tree_leaves(abstract))
    assert _shapes(abstract) == _shapes(
        lm.init_params(cfg, gen, device="cpu"))
    assert _shapes(lm.abstract_cache(cfg, BATCH, 48)) == _shapes(
        lm.init_cache(cfg, BATCH, 48, device="cpu"))
    # at full width, against the JAX package's trees
    jax_cfg = jax_registry.get_config(arch)
    assert _shapes(lm.abstract_params(full)) == _shapes(
        jax_lm.abstract_params(jax_cfg))
    assert _shapes(lm.abstract_cache(full, 4, 4096)) == _shapes(
        jax_lm.abstract_cache(jax_cfg, 4, 4096))


def test_cells_and_input_specs_match_the_jax_package():
    applicable = 0
    for arch in registry.ARCH_IDS:
        cfg, jax_cfg = registry.get_config(arch), jax_registry.get_config(arch)
        for shape in SHAPES:
            ok = registry.cell_is_applicable(cfg, shape)
            assert ok == jax_registry.cell_is_applicable(jax_cfg, shape)
            applicable += ok[0]
            ours = registry.input_specs(cfg, shape)
            theirs = jax_registry.input_specs(jax_cfg, shape)
            assert ours.keys() == theirs.keys()
            for key, spec in ours.items():
                if key == "pos":
                    # an int where the JAX package has an int32 scalar
                    assert spec == SHAPES[shape]["seq"] - 1
                    assert theirs[key].shape == ()
                else:
                    assert _shapes(spec) == _shapes(theirs[key]), key
    assert applicable == 33


def test_argument_bytes_are_the_real_state_and_batch(monkeypatch):
    use_tiny_cells(monkeypatch)
    for arch in ("phi4_mini_3_8b", "mixtral_8x22b", "whisper_medium"):
        art = port_cell(arch, "tiny_train")
        cfg = registry.get_config(arch)
        plan = plan_lm(cfg, "tiny_train", MeshSpec((("data", 1),)),
                       hw=H100_SXM, overrides={"microbatches": 1})
        params = lm.init_params(plan.cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        state = [params, make_optimizer(plan).init(params),
                 torch.zeros((), dtype=torch.int32)]
        S = TINY["tiny_train"]["seq"]
        batch = [torch.zeros((BATCH, S), dtype=torch.int32)]
        if cfg.family == "encdec":
            batch.append(torch.zeros((BATCH, cfg.enc_seq, cfg.d_model),
                                     dtype=dtype_of(cfg.compute_dtype)))
        real = sum(t.numel() * t.element_size()
                   for t in tree_leaves([state, batch]))
        mem = art["memory"]
        assert mem["argument_bytes"] == real
        # the step updates params and moments in place and returns them;
        # the step counter it returns is a new int32 scalar
        assert mem["alias_bytes"] == real - 4 - sum(
            t.numel() * t.element_size() for t in batch)
        assert mem["peak_hbm_estimate"] == (
            mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
            - mem["alias_bytes"])
        assert mem["temp_bytes"] > 0


def _jax_artifact_keys():
    """The keys of the JAX package's artifact, read from its source (its
    module locks JAX to 512 host devices when imported)."""

    path = Path(jax_hlo_analysis.__file__).with_name("dryrun.py")
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "artifact"):
            keys = {}
            for k, v in zip(node.value.keys, node.value.values):
                keys[k.value] = ({kk.value for kk in v.keys}
                                 if isinstance(v, ast.Dict) else None)
            return keys
    raise AssertionError("no artifact dict in the JAX package's dry run")


def test_artifact_holds_the_jax_artifact_keys(tmp_path, monkeypatch, capsys):
    want = _jax_artifact_keys()
    monkeypatch.setattr(dryrun, "ARTIFACT_DIR", str(tmp_path))
    assert dryrun.main(["--arch", "mamba2_130m", "--shape",
                        "long_500k"]) == 0
    assert "roofline: compute=" in capsys.readouterr().out
    art = json.loads((tmp_path / "mamba2_130m__long_500k__one.json")
                     .read_text())
    assert want.keys() <= art.keys()
    for key in ("plan", "memory", "collectives"):
        assert art[key].keys() == want[key], key
    # XLA's uncorrected cost and while_trips have no eager counterpart
    assert art["cost"].keys() == want["cost"] - {
        "xla_flops_uncorrected", "xla_bytes_uncorrected", "while_trips"}
    census = jax_hlo_analysis.HLOCensus()
    assert art["roofline"].keys() == \
        jax_hlo_analysis.roofline_terms(census, 1).keys()
    assert art["hardware"] == "h100-sxm"
    assert art["roofline"]["dominant"] == "memory_s"
    assert art["collectives"]["ici_link_bytes"] == 0


def test_skipped_cell_and_the_jax_meshes():
    art = dryrun.run_cell("phi4_mini_3_8b", "long_500k", "one")
    _, why = jax_registry.cell_is_applicable(
        jax_registry.get_config("phi4_mini_3_8b"), "long_500k")
    assert art["status"] == "skipped" and art["reason"] == why
    for mesh in ("single", "multi"):
        with pytest.raises(NotImplementedError, match="A10"):
            dryrun.run_cell("phi4_mini_3_8b", "decode_32k", mesh)
    with pytest.raises(NotImplementedError, match="A10"):
        dryrun.main(["--arch", "mamba2_130m", "--shape", "decode_32k",
                     "--mesh", "multi"])
