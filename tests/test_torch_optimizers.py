"""The port's lamb, lion and adafactor, `flat_updates` and the plateau
controller against the JAX package's optax chain, on the CPU.

Each optimizer runs 5 steps on the tiny model's parameter tree (a JAX
`model.init`, its arrays in the port's layout through `state_dict_from_jax`:
Dense kernels transposed) with the same random gradients, with and without
`flat_updates`, gradient clipping and accumulation; the parameters agree with
optax's after every step to 1e-6. The plateau controller and scale are held
to `PlateauController` and `set_plateau_scale` over a sequence of epoch
losses, and across a save and resume.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from scoreperformer_tpu.training import optimizers as joptim

from scoreperformer_tpu_torch.convert import _flatten, _torch_name_for
from scoreperformer_tpu_torch.training import optimizers as toptim

from test_torch_modules import build_pair, make_inputs, tiny_config

torch.set_num_threads(1)
TOL = dict(atol=1e-6, rtol=1e-6)

OPTIMIZERS = {
    "lamb": dict(optimizer="lamb", lr=0.05, optimizer_params={"weight_decay": 1e-2}),
    "lion": dict(optimizer="lion", lr=0.01),
    "adafactor": dict(optimizer="adafactor", lr=0.1),
    # dims of 16 and more factored: the (16, 16) value kernels are square,
    # so the JAX layout decides which dim is which
    "adafactor_factored": dict(optimizer="adafactor", lr=0.1, optimizer_params={
        "min_dim_size_to_factor": 16, "momentum": 0.9, "weight_decay_rate": 1e-3}),
}
VARIANTS = {"": {}, "clip_accum": dict(grad_clip=1.0, grad_accum_steps=2, lr_scheduler="exponential",
                                       lr_scheduler_params={"gamma": 0.5})}
CASES = [(o, v, flat) for o in OPTIMIZERS for v in VARIANTS for flat in (False, True)]


@pytest.fixture(scope="module")
def tree():
    """The tiny model's JAX parameters, and {path: (port name, transposed)}."""
    _, variables, _ = build_pair(tiny_config(), make_inputs())
    params = jax.device_get(variables["params"])
    names = {path: _torch_name_for(list(path)) for path in _flatten(params)}
    return params, {path: (name, t == "t") for path, (name, t) in names.items()}


def port_layout(tree_, names):
    """A JAX tree as {port name: tensor} in the port's layout."""
    return {names[path][0]: torch.from_numpy(np.array(v.T if names[path][1] else v))
            for path, v in _flatten(tree_).items()}


def random_grads(params, step):
    leaves, treedef = jax.tree.flatten(params)
    return jax.tree.unflatten(treedef, [np.random.RandomState(100 * step + i).randn(*np.shape(x)).astype(np.float32)
                                        for i, x in enumerate(leaves)])


def optax_run(cfg, params, grads_seq, scales=None):
    """Parameters after each optax update (`scales[i]` set as the plateau
    scale before step i)."""
    tx = joptim.build_optimizer(joptim.OptimizerConfig.from_dict(cfg), steps_per_epoch=2)
    state = tx.init(params)
    update = jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(*tx.update(g, s, p)))
    out = []
    for i, g in enumerate(grads_seq):
        if scales is not None:
            state = joptim.set_plateau_scale(state, scales[i])
        params, state = update(g, state, params)
        out.append(jax.device_get(params))
    return out


def port_optimizer(cfg, params, names):
    tparams = {k: torch.nn.Parameter(v) for k, v in port_layout(params, names).items()}
    transposed = [name for name, t in names.values() if t]
    paths = {name: path for path, (name, _) in names.items()}
    return tparams, toptim.Optimizer(tparams.items(), toptim.OptimizerConfig.from_dict(cfg), 2, transposed,
                                     paths=paths)


def port_step(opt, tparams, grads, names):
    for k, g in port_layout(grads, names).items():
        tparams[k].grad = g
    opt.step()


def assert_same(tparams, want, names, what):
    for k, v in port_layout(want, names).items():
        np.testing.assert_allclose(tparams[k].detach().numpy(), v.numpy(), err_msg=f"{k} {what}", **TOL)


@pytest.mark.parametrize("opt_name,variant,flat", CASES,
                         ids=[f"{o}{'_' + v if v else ''}{'_flat' if f else ''}" for o, v, f in CASES])
def test_optimizer_matches_optax_on_the_model_tree(tree, opt_name, variant, flat):
    params, names = tree
    cfg = {**OPTIMIZERS[opt_name], **VARIANTS[variant], "flat_updates": flat}
    grads = [random_grads(params, s) for s in range(5)]
    want = optax_run(cfg, params, grads)
    tparams, opt = port_optimizer(cfg, params, names)
    if opt_name == "adafactor_factored":
        factored = [d for d in opt.factored_dims if d is not None]
        assert (not factored) if flat else len(factored) > 20
    for step, g in enumerate(grads):
        port_step(opt, tparams, g, names)
        assert_same(tparams, want[step], names, f"after step {step}")


def decoder_mask(params):
    """A mask tree over the model's flax paths, a prefix of it in places:
    every stack but the decoder's transformer takes weight decay."""
    mask = {k: True for k in params}
    mask["perf_decoder"] = {k: k != "transformer" for k in params["perf_decoder"]}
    return mask


# each optax option on the model tree: (config, the port's callable mask where JAX's differs)
OPTION_CASES = {
    "adamw_mu_dtype": dict(optimizer="adamw", lr=0.05, optimizer_params={"mu_dtype": "bfloat16",
                                                                         "weight_decay": 1e-2}),
    "adamw_mask": dict(optimizer="adamw", lr=0.05, optimizer_params={"weight_decay": 1e-2, "mask": "tree"}),
    "adamw_mask_callable": dict(optimizer="adamw", lr=0.05, optimizer_params={"weight_decay": 1e-2,
                                                                              "mask": "matrices"}),
    "adam_nesterov_mu_dtype": dict(optimizer="adam", lr=0.05, optimizer_params={"nesterov": True,
                                                                                "mu_dtype": "bfloat16"}),
    "lamb_mask": dict(optimizer="lamb", lr=0.05, optimizer_params={"weight_decay": 1e-2, "mask": "tree"}),
    "lion_mu_dtype_mask": dict(optimizer="lion", lr=0.01, optimizer_params={"mu_dtype": "bfloat16", "mask": "tree"}),
    "sgd_accumulator_dtype": dict(optimizer="sgd", lr=0.05, optimizer_params={"momentum": 0.9, "nesterov": True,
                                                                              "accumulator_dtype": "bfloat16"}),
    # a bf16 ema: test_adafactor_bf16_momentum_is_optax_s_within_one_bf16_ulp
    "adafactor_weight_decay_mask": dict(optimizer="adafactor", lr=0.1, optimizer_params={
        "min_dim_size_to_factor": 16, "momentum": 0.9, "dtype_momentum": "float32", "weight_decay_rate": 1e-3,
        "weight_decay_mask": "tree"}),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_optax_dtype_and_mask_options_match_optax(tree, case):
    """mu_dtype, accumulator_dtype, dtype_momentum (bf16 moments), mask and
    weight_decay_mask (a tree of booleans over the flax paths, a prefix in
    places, or a callable: matrices only) and adam's nesterov, 5 steps on
    the model tree: the parameters equal optax's to 1e-6 after every step,
    and each moment is held in the dtype asked for."""
    params, names = tree
    cfg = OPTION_CASES[case]
    opts = dict(cfg["optimizer_params"])
    key = "weight_decay_mask" if "weight_decay_mask" in opts else "mask"
    jcfg, tcfg = dict(cfg), dict(cfg)
    if opts.get(key) == "tree":
        jcfg["optimizer_params"] = tcfg["optimizer_params"] = {**opts, key: decoder_mask(params)}
    elif opts.get(key) == "matrices":
        jcfg["optimizer_params"] = {**opts, key: lambda p: jax.tree.map(lambda x: x.ndim > 1, p)}
        tcfg["optimizer_params"] = {**opts, key: lambda p: torch.utils._pytree.tree_map(lambda x: x.ndim > 1, p)}
    grads = [random_grads(params, s) for s in range(5)]
    want = optax_run(jcfg, params, grads)
    tparams, opt = port_optimizer(tcfg, params, names)
    if "mask" in case:
        assert 0 < sum(opt.decays) < len(opt.decays)
    for step, g in enumerate(grads):
        port_step(opt, tparams, g, names)
        assert_same(tparams, want[step], names, f"after step {step}")
    held = opt.mu if opt.mu is not None else opt.trace
    dtype = opts.get("mu_dtype", opts.get("accumulator_dtype", opts.get("dtype_momentum")))
    if dtype is not None:
        assert {t.dtype for t in held} == {getattr(torch, dtype)}


def test_adafactor_bf16_momentum_is_optax_s_within_bf16_rounding(tree):
    """adafactor with its ema in bf16 (`dtype_momentum`), factored moments,
    clipping and the parameter scale, 5 steps on the model tree. The fp32
    update before the cast agrees with optax's to an fp32 ulp, not bit for
    bit (XLA's pow(v, -0.5) is correctly rounded where torch's rsqrt is
    not, and the RMS sums add in another order), so where that update lies
    within an ulp of a bf16 rounding boundary the two round to neighbouring
    bf16 values (5 to 15 of 70,938 elements a step here), and the next
    steps carry the difference. The stored ema is held to optax's within
    two bf16 ulps of its tensor's largest value, equal in all but 1 of
    1,000 elements; the parameters to 1e-6 in all but 1 of 1,000 elements
    and to 1e-4 everywhere."""
    params, names = tree
    cfg = dict(optimizer="adafactor", lr=0.1, optimizer_params={
        "min_dim_size_to_factor": 16, "momentum": 0.9, "dtype_momentum": "bfloat16"})
    tx = joptim.build_optimizer(joptim.OptimizerConfig.from_dict(cfg), steps_per_epoch=2)
    state, jp = tx.init(params), params
    update = jax.jit(lambda g, s, p: (lambda u, s: (optax.apply_updates(p, u), s))(*tx.update(g, s, p)))
    tparams, opt = port_optimizer(cfg, params, names)
    eps = float(torch.finfo(torch.bfloat16).eps)
    for step in range(5):
        g = random_grads(params, step)
        jp, state = update(g, state, jp)
        port_step(opt, tparams, g, names)
        ema = {tuple(k.key for k in path if isinstance(k, jax.tree_util.DictKey)): np.asarray(x.astype(jnp.float32))
               for path, x in jax.tree_util.tree_flatten_with_path(state)[0] if x.dtype == jnp.bfloat16}
        assert set(ema) == set(names)
        held = dict(zip(opt.names, opt.trace))
        differ, total = 0, 0
        for path, (name, transposed) in names.items():
            want = torch.from_numpy(ema[path].T.copy() if transposed else ema[path].copy())
            diff = (held[name].float() - want).abs()
            assert diff.max() <= 2 * eps * want.abs().max(), (step, name)
            differ, total = differ + int((diff > 0).sum()), total + diff.numel()
        assert differ < 1e-3 * total, (step, differ, total)
        got = torch.cat([tparams[k].detach().reshape(-1) for k in port_layout(jp, names)])
        want = torch.cat([v.reshape(-1) for v in port_layout(jax.device_get(jp), names).values()])
        err = (got - want).abs() / want.abs().clamp_min(1.0)
        assert err.max() < 1e-4 and (err > 1e-6).float().mean() < 1e-3, (step, err.max(), (err > 1e-6).sum())
    assert {t.dtype for t in opt.trace} == {torch.bfloat16}


SPLIT_SHAPES = {"rows": (24, 20), "cols": (20, 24), "kernel": (20, 24), "glu": (32, 12), "experts": (4, 12, 24),
                "bias": (24,)}


def test_adafactor_over_a_split_parameter_matches_optax_on_the_whole_one():
    """adafactor (factored from 8, momentum, weight decay, clipping and the
    parameter scale) on parameters a (model 2 x expert 2) mesh splits: on
    the dim its row moments reduce ("rows"), on the dim its column moments
    and the rows' mean reduce ("cols"; "kernel" the same in the JAX layout,
    transposed), both halves of a GLU projection ("glu"), the expert axis
    of an expert kernel ("experts"), beside a whole one. 3 updates: each
    rank's blocks equal the blocks of optax's updates of the whole
    parameters to 1e-6, and every 2-D and 3-D parameter is factored."""
    from scoreperformer_tpu_torch.parallel.launch import launch
    from scoreperformer_tpu_torch.parallel.shard import Shard
    from test_torch_parallel_workers import split_optimizer_worker

    cfg = dict(optimizer="adafactor", lr=0.05, optimizer_params={
        "min_dim_size_to_factor": 8, "momentum": 0.9, "weight_decay_rate": 1e-3})
    params = {k: np.random.RandomState(i).randn(*s).astype(np.float32) for i, (k, s) in enumerate(SPLIT_SHAPES.items())}
    grads = [{k: np.random.RandomState(50 + 7 * t + i).randn(*s).astype(np.float32)
              for i, (k, s) in enumerate(SPLIT_SHAPES.items())} for t in range(3)]
    splits = {"rows": Shard("model", 0), "cols": Shard("model", 0), "kernel": Shard("model", 1),
              "glu": Shard("model", 0, halves=2), "experts": Shard("expert", 0)}
    # the JAX layout of "kernel" is its transpose: optax factors (24, 20)
    jparams = {k: jnp.asarray(v.T if k == "kernel" else v) for k, v in params.items()}
    tx = joptim.build_optimizer(joptim.OptimizerConfig.from_dict(cfg))
    state = tx.init(jparams)
    for g in grads:
        u, state = tx.update({k: jnp.asarray(v.T if k == "kernel" else v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, u)
    want = {k: torch.from_numpy(np.asarray(v).T.copy() if k == "kernel" else np.asarray(v).copy())
            for k, v in jparams.items()}
    results = launch(split_optimizer_worker, 4, (cfg, params, grads, splits, ["kernel"]), device="cpu")
    for res in results:
        assert all(res["factored"][k] for k in SPLIT_SHAPES if k != "bias")
        for k, w in want.items():
            spec = splits.get(k)
            block = w if spec is None else spec.take(w, 2, res["coords"][spec.axis])
            np.testing.assert_allclose(res["params"][k], block.numpy(), err_msg=f"{k} at {res['coords']}", **TOL)


def test_flat_updates_change_lamb_and_adafactor():
    """optax.flatten changes results, not only speed: one trust ratio (lamb)
    and one clipping and parameter scale over the whole vector, nothing
    factored (adafactor). The port moves with it."""
    shapes = {"w": (200, 130), "b": (7,)}
    params = {k: np.random.RandomState(i).randn(*s).astype(np.float32) * (i + 1) for i, (k, s) in enumerate(shapes.items())}
    grads = {k: np.random.RandomState(10 + i).randn(*s).astype(np.float32) for i, (k, s) in enumerate(shapes.items())}
    for name in ("lamb", "adafactor"):
        out = {}
        for flat in (False, True):
            tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
            opt = toptim.Optimizer(tparams.items(), toptim.OptimizerConfig(optimizer=name, lr=0.1, flat_updates=flat))
            for k, p in tparams.items():
                p.grad = torch.from_numpy(grads[k])
            opt.step()
            tx = joptim.build_optimizer(joptim.OptimizerConfig(optimizer=name, lr=0.1, flat_updates=flat))
            jp = {k: jnp.asarray(v) for k, v in params.items()}
            u, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, tx.init(jp), jp)
            want = optax.apply_updates(jp, u)
            for k in shapes:
                np.testing.assert_allclose(tparams[k].detach().numpy(), np.asarray(want[k]), err_msg=f"{name} {k}", **TOL)
            out[flat] = tparams["b"].detach().clone()
        assert not torch.allclose(out[False], out[True]), name


EPOCH_LOSSES = [5.0, 4.0, 4.0, 3.9999, 4.1, 4.2, 3.0, 3.1, 3.2, 3.3, 3.4, 3.5, 2.0]


def test_plateau_controller_matches_jax():
    """Scale after each epoch loss, with patience, threshold, cooldown and
    the min_lr floor, against the JAX controller; and its state across a
    save and load at every epoch."""
    cfg = dict(lr=0.1, lr_scheduler="plateau", lr_scheduler_params={
        "factor": 0.5, "patience": 1, "threshold": 1e-3, "cooldown": 1, "min_lr": 0.02})
    want = joptim.PlateauController.from_config(joptim.OptimizerConfig.from_dict(cfg))
    got = toptim.PlateauController.from_config(toptim.OptimizerConfig.from_dict(cfg))
    scales = []
    for loss in EPOCH_LOSSES:
        scales.append(want.step(loss))
        resumed = toptim.PlateauController.from_config(toptim.OptimizerConfig.from_dict(cfg))
        resumed.load_state_dict(got.state_dict())
        got = resumed
        assert got.step(loss) == scales[-1]
        assert got.state_dict() == want.state_dict()
    assert scales[-1] == pytest.approx(0.2) and scales[1] == 1.0
    assert toptim.PlateauController.from_config(toptim.OptimizerConfig(lr=0.1)) is None


def test_plateau_scale_matches_set_plateau_scale_across_a_resume(tree):
    """adamw with the plateau scale set before each step as a controller
    sets it once an epoch (two steps), against optax with
    `set_plateau_scale`; at step 3 the port's optimizer is saved and a new
    one resumes from its state dict."""
    params, names = tree
    cfg = dict(optimizer="adamw", lr=0.01, grad_clip=1.0, lr_scheduler="plateau",
               lr_scheduler_params={"factor": 0.5, "patience": 0})
    grads = [random_grads(params, s) for s in range(6)]
    scales = [1.0, 1.0, 0.5, 0.5, 0.25, 0.25]
    want = optax_run(cfg, params, grads, scales)
    tparams, opt = port_optimizer(cfg, params, names)
    for step, g in enumerate(grads):
        if step == 3:
            state = opt.state_dict()
            _, opt = port_optimizer(cfg, params, names)
            opt.params = list(tparams.values())
            opt.load_state_dict(state)
            assert opt.plateau_scale == 0.5
        opt.plateau_scale = scales[step]
        port_step(opt, tparams, g, names)
        assert_same(tparams, want[step], names, f"after step {step}")
