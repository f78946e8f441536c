"""The repository's recipes in the port, on the CPU.

Every decoder that a recipe configures fits the head dims and head counts of
the `prefix_attend` kernel, to which the chunked decode sends every step's
prefix on the card; recipes/scoreperformer/scale_1024.yaml builds (on the
meta device, so its parameters are not allocated); and the configs that
chip_smoke.py writes out (the card's machine may have no PyYAML) are the
recipes' own; recipes/performer.yaml and the untied-head ablation build;
every recipe's model builds, recipes/scoreperformer/moe.yaml's with its 5
MoE layers in all three stacks.
"""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from scoreperformer_tpu_torch.configs.yaml_loader import load_experiment_config
from scoreperformer_tpu_torch.models.attention import Attention
from scoreperformer_tpu_torch.models.embeddings import TupleTokenLMHead, TupleTokenTiedLMHead
from scoreperformer_tpu_torch.models.moe import MoEFeedForward
from scoreperformer_tpu_torch.models.factory import build_model, build_scoreperformer_config
from scoreperformer_tpu_torch.models.scoreperformer import PerformerModel, ScorePerformerModel
from scoreperformer_tpu_torch.ops.prefix_attend import KERNEL_HEAD_DIMS, KERNEL_HEADS
from scoreperformer_tpu_torch.tokenizers import SPMupleWindow, TokenizerConfig
from scoreperformer_tpu_torch.training.components import inject_data_config

ROOT = Path(__file__).resolve().parents[1]
RECIPES = sorted(str(p.relative_to(ROOT / "recipes")) for p in (ROOT / "recipes").rglob("*.yaml"))


@pytest.fixture(scope="module")
def tokenizer():
    return SPMupleWindow(TokenizerConfig(additional_params={"max_bar_embedding": 256}))


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def injected_model(name, tokenizer):
    """A recipe's `model:` node with the tokenizer's vocab and token values
    injected as training injects them (no direction labels)."""
    model = load_experiment_config(ROOT / "recipes", name)["model"]
    return inject_data_config(model, SimpleNamespace(tokenizer=tokenizer))


def test_the_recipes_are_found():
    assert {"smoke.yaml", "scoreperformer/base.yaml", "scoreperformer/scale_1024.yaml"} <= set(RECIPES)


@pytest.mark.parametrize("name", RECIPES)
def test_every_recipe_decoder_fits_prefix_attend(name):
    """The decoder's self-attention (the ScorePerformer's perf_decoder, the
    Performer's transformer): head dim in KERNEL_HEAD_DIMS, head count in
    KERNEL_HEADS, one KV head or one per query head."""
    model = load_experiment_config(ROOT / "recipes", name).get("model", {})
    if model.get("_name_") == "ScorePerformer":
        stack = build_scoreperformer_config(model).perf_decoder.transformer
        heads, att = stack.heads, stack.attention
        dim_head, kv_heads = att.dim_head, 1 if att.one_kv_head else stack.heads
    elif "transformer" in model:  # the Performer: model.transformer.transformer
        stack = model["transformer"]["transformer"]
        att = stack["attention"]
        heads, dim_head = stack["heads"], att["dim_head"]
        kv_heads = 1 if att.get("one_kv_head") else heads
    else:  # recipes/default.yaml: the shared trainer settings, no model
        assert not model.get("transformer") and model.get("_name_") in (None, "???"), name
        return
    assert dim_head in KERNEL_HEAD_DIMS and heads in KERNEL_HEADS and kv_heads in (1, heads), (
        f"{name}: decoder heads {heads} of {dim_head}, {kv_heads} KV heads")


def test_scale_1024_builds_and_its_decoder_fits_prefix_attend(tokenizer):
    """Built on the meta device (285,416,448 parameters with this tokenizer's
    vocabularies), every stack's config with fused_mask_select (the port
    always fuses), every attention layer with softmax_bf16, decoder self-attention 8 heads of 128 with one KV head,
    inside the kernel's head dims and counts."""
    cfg = build_scoreperformer_config(injected_model("scoreperformer/scale_1024.yaml", tokenizer))
    stacks = [cfg.score_encoder.transformer, cfg.perf_encoder.transformer, cfg.perf_decoder.transformer]
    assert all(s.attention.fused_mask_select for s in stacks)
    with torch.device("meta"):
        model = ScorePerformerModel(cfg, device="meta")
    assert all(p.device.type == "meta" for p in model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == 285_416_448, n_params
    attention = [m for m in model.modules() if isinstance(m, Attention)]
    assert attention and all(m.softmax_bf16 for m in attention)
    decoder = [m for m in model.decoder.modules() if isinstance(m, Attention) and m.causal]
    assert len(decoder) == 8
    for m in decoder:
        assert (m.heads, m.dim_head, m.kv_heads) == (8, 128, 1)
        assert m.dim_head in KERNEL_HEAD_DIMS and m.heads in KERNEL_HEADS


def strip(model):
    """A recipe's `model:` node less its name, version and classifiers."""
    return {k: v for k, v in model.items() if k not in ("_name_", "_version_", "classifiers")}


def test_chip_smoke_configs_are_the_recipes(tokenizer, chip_smoke):
    """chip_smoke.py's scale_1024 model is the recipe's `model:` node less
    the direction classifiers; its smoke-shaped model is recipes/smoke.yaml's
    with the positions and segments a served bucket of 384 needs."""
    assert chip_smoke.scale_1024_config(tokenizer) == strip(injected_model("scoreperformer/scale_1024.yaml",
                                                                           tokenizer))
    smoke = strip(injected_model("smoke.yaml", tokenizer))
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        smoke[key]["max_seq_len"] = 386
    smoke["perf_encoder"]["max_segments"] = 388
    assert chip_smoke.smoke_config(tokenizer, 384) == smoke


@pytest.mark.parametrize("name", ["performer.yaml", "scoreperformer/ablation/no_io_tie.yaml"])
def test_performer_and_untied_head_recipes_build(name, tokenizer):
    """recipes/performer.yaml (the standalone Performer: 4 decoder layers of
    4 heads of 64, one KV head, the tied head) and the ablation with the
    untied `lm` head build in the port, on the meta device."""
    node = load_experiment_config(ROOT / "recipes", name)["model"]
    model, cfg = build_model(node["_name_"], injected_model(name, tokenizer), device="meta", seed=None)
    assert all(p.device.type == "meta" for p in model.parameters())
    if node["_name_"] == "Performer":
        assert isinstance(model, PerformerModel) and cfg.mode == "clm"
        assert isinstance(model.decoder.lm_head, TupleTokenTiedLMHead)
        decoder = [m for m in model.decoder.modules() if isinstance(m, Attention)]
        assert len(decoder) == 4 and all((m.heads, m.dim_head, m.kv_heads, m.causal) == (4, 64, 1, True)
                                         for m in decoder)
    else:
        assert isinstance(model, ScorePerformerModel)
        head = model.decoder.lm_head
        assert isinstance(head, TupleTokenLMHead) and list(head.heads) == list(tokenizer.performance_sizes)
        assert all(head.heads[k].out_features == n for k, n in tokenizer.performance_sizes.items())


def test_chip_smoke_performer_nodes_are_the_recipe(chip_smoke):
    """chip_smoke.py's Performer phase trains recipes/performer.yaml's own
    dataset, collator, model and evaluator nodes."""
    recipe = load_experiment_config(ROOT / "recipes", "performer.yaml")
    assert chip_smoke.PERFORMER_DATASET == recipe["data"]["dataset"]
    assert chip_smoke.PERFORMER_COLLATOR == recipe["data"]["collator"]
    assert chip_smoke.PERFORMER_MODEL == recipe["model"]
    assert chip_smoke.PERFORMER_EVALUATOR == recipe["evaluator"]
    assert recipe["trainer"]["batch_size"] == chip_smoke.TRAIN_BATCH


@pytest.mark.parametrize("name", RECIPES)
def test_every_recipe_model_builds(name, tokenizer):
    """Each of the 15 recipes' models builds in the port on the meta device
    (no direction labels are injected, so no classifier heads);
    recipes/default.yaml, the 16th file, holds the shared trainer settings
    and no model."""
    assert len(RECIPES) == 16
    node = load_experiment_config(ROOT / "recipes", name).get("model", {})
    if node.get("_name_") in (None, "???"):
        assert name == "default.yaml"
        return
    model, _ = build_model(node["_name_"], injected_model(name, tokenizer), device="meta", seed=None)
    assert sum(p.numel() for p in model.parameters()) > 0
    assert all(p.device.type == "meta" for p in model.parameters())


def test_moe_recipe_puts_moe_layers_in_all_three_stacks(tokenizer, chip_smoke):
    """base.yaml points both encoders' feed_forward at the decoder's, so
    moe.yaml's MoE feed-forward reaches all three stacks: every 2nd
    feed-forward (moe_stride 2, counted per stack) of the score encoder (2
    deep), the performance encoder (4) and the decoder (4), 5 layers of 4
    GLU-swish experts, top-2, at the model's dim 256 (the stacks' configs
    keep TransformerConfig's default dim 512, which the model replaces)."""
    model, _ = build_model("ScorePerformer", injected_model("scoreperformer/moe.yaml", tokenizer), device="meta",
                           seed=None)
    assert chip_smoke.moe_stacks(model) == {"score_encoder": [3], "perf_encoder": [3, 7], "perf_decoder": [3, 7]}
    layers = [m for m in model.modules() if isinstance(m, MoEFeedForward)]
    assert len(layers) == 5
    for m in layers:
        assert (m.num_experts, m.top_k, m.capacity_factor, m.glu, m.swish) == (4, 2, 1.25, True, True)
        assert (tuple(m.router.shape), tuple(m.wi.shape), tuple(m.wo.shape)) == ((256, 4), (4, 256, 2048), (4, 1024, 256))
        assert m.router_aux_weight == 0.01 and m.bi is None
        # the capacity of a training sequence (258, the decoder's 257 after
        # the shift), a decode step, a served bucket
        assert [m.capacity(s) for s in (258, 257, 1, 384)] == [162, 161, 1, 240]


def test_chip_smoke_moe_config_is_the_recipe(tokenizer, chip_smoke):
    """chip_smoke.py's MoE model is moe.yaml's `model:` node (base.yaml's
    resolved, MoE in all three stacks), its classifiers base.yaml's."""
    recipe = injected_model("scoreperformer/moe.yaml", tokenizer)
    assert chip_smoke.moe_config(tokenizer) == strip(recipe)
    assert chip_smoke.moe_train_config(tokenizer, "root", "out", 128, 2)["model"]["classifiers"] == recipe["classifiers"]


def test_chip_smoke_flash_configs_are_the_recipes_with_use_flash(tokenizer, chip_smoke):
    """chip_smoke.py's scale regime with the flash kernels is scale_1024.yaml's
    model with `use_flash` in each stack's attention node, the decoder's
    attention dropout set, and positions and segments for the sequence
    length; its smoke-shaped one is recipes/smoke.yaml's with `use_flash` and
    no attention dropout in the node all three stacks share (segments for
    its 48 notes, as smoke_config sets them). Every flash
    layer's head dim is one the kernels take."""
    from scoreperformer_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS as FLASH_HEAD_DIMS

    recipe = strip(injected_model("scoreperformer/scale_1024.yaml", tokenizer))
    for seq, dropout in ((1024, 0.0), (2048, 0.0), (1024, 0.1)):
        cfg = chip_smoke.scale_flash_config(tokenizer, seq, dropout)
        want = json_copy(recipe)
        for key in ("score_encoder", "perf_encoder", "perf_decoder"):
            want[key]["transformer"]["attention"]["use_flash"] = True
            want[key]["max_seq_len"] = seq + 2
        want["perf_decoder"]["transformer"]["attention"]["dropout"] = dropout
        want["perf_encoder"]["max_segments"] = seq + 4
        assert cfg == want
    smoke = chip_smoke.smoke_flash_config(tokenizer, 48)
    want = strip(injected_model("smoke.yaml", tokenizer))
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        want[key]["transformer"]["attention"].update(use_flash=True, dropout=0.0)
    want["perf_encoder"]["max_segments"] = 48 + 4  # smoke_config's segments for its notes
    assert smoke == want
    cfg = build_scoreperformer_config(chip_smoke.scale_flash_config(tokenizer))
    with torch.device("meta"):
        model = ScorePerformerModel(cfg, device="meta")
    flash = {(m.heads, m.dim_head, m.kv_heads, m.causal) for m in model.modules()
             if isinstance(m, Attention) and m.use_flash}
    assert flash == {(8, 64, 8, False), (8, 128, 1, True)}
    assert all(d in FLASH_HEAD_DIMS for _, d, _, _ in flash)


def json_copy(x):
    import json

    return json.loads(json.dumps(x))


@pytest.mark.parametrize("seq", [1024, 2048])
def test_a_scale_flash_recipe_over_scale_1024_yaml_is_chip_smokes_config(tokenizer, chip_smoke, tmp_path, seq):
    """The README's way to train the scale regime with the flash kernels: a
    recipe whose `base:` is scale_1024.yaml, with `use_flash: true` in each
    stack's attention node (the decoder's with `dropout: 0.0`) and, at 2048
    notes, the positions and segments, gives `scale_flash_config`'s model."""
    lines = [f"base: {ROOT / 'recipes' / 'scoreperformer' / 'scale_1024.yaml'}", "data:", "  dataset:",
             f"    max_seq_len: {seq}", "model:"]
    for key in ("score_encoder", "perf_encoder", "perf_decoder"):
        lines += [f"  {key}:", f"    max_seq_len: {seq + 2}", "    transformer:", "      attention:",
                  "        use_flash: true"]
        if key == "perf_decoder":
            lines.append("        dropout: 0.0")
        if key == "perf_encoder":
            lines.append(f"    max_segments: {seq + 4}")
    (tmp_path / "scale_flash.yaml").write_text("\n".join(lines) + "\n")
    model = load_experiment_config(tmp_path, "scale_flash.yaml")["model"]
    got = strip(inject_data_config(model, SimpleNamespace(tokenizer=tokenizer)))
    assert got == chip_smoke.scale_flash_config(tokenizer, seq)
