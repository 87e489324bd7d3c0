"""The port's meta-training CLI (`mliis_tpu_torch/cli/args.py`) against the
JAX package's: the same parser (every flag's default, type, nargs and
choices; run.sh's flags and no flags parse to the same namespace), the
same configs from every config function, field by field over the fields
both dataclasses have, the same parameter count for the same flags, a
loud NotImplementedError, naming its ROADMAP.md item, for every flag whose
feature the port lacks, and no error for the flags it has ported.

Fields one side has and the other does not, and why:
  - model_kwargs: none; `spatial_pyramid_pooling` and `skip_decoding` are
    on both sides.
  - TrainLoopConfig: `task_group_size`, `chain_tasks` and
    `chain_eval_chunk` are JAX-only execution strategies; the port always
    runs the meta-batch one task after another, which the JAX package's
    chained step does with the same draws.
  - EvalConfig: `task_chunk_size` and `chain_chunk` are JAX-only, for the
    same reason (evaluation tasks run one after another).
Every other config field exists on both sides and must be equal.
"""
import dataclasses
import shlex

import jax
import jax.numpy as jnp
import pytest

from mliis_tpu.cli import args as jargs
from mliis_tpu.models.efficientlab import EfficientLab as JEfficientLab
from mliis_tpu.ops.meta_math import tree_count_params as jcount
from mliis_tpu_torch.cli import args as targs
from mliis_tpu_torch.cli import run_metasegnet as trun
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.ops.meta_math import tree_count_params

# run.sh:9-21, data and checkpoint directories named.
RUN_SH_FLAGS = (
    "--fss_1000 --image_size 224 --pretrained --rsd 2 4 --l2 "
    "--foml --foml-tail 5 --final_layer_dropout_rate 0.5 --augment "
    "--aug_rate 0.5 --sgd --loss_name bce_dice --inner-batch 8 "
    "--learning-rate 0.0005 --train-shots 10 --inner-iters 59 "
    "--learning_rate_scheduler fixed --meta-iters 50000 --meta-batch 5 "
    "--eval-interval 500 --serially_eval_all_test_tasks --eval-samples 2 "
    "--shots 5 --eval-batch 8 --eval-iters 59 --transductive "
    "--model_name efficientlab --meta-step 0.1 --meta-step-final 0.00001 "
    "--chain_tasks --chain_eval_chunk --task_chunk_size 8 "
    "--checkpoint ckpt --data-dir shards")

FLAG_SETS = {
    "run_sh": RUN_SH_FLAGS,
    "defaults": "",
    "protocol": ("--replacement --learning_rate_scheduler step_decay "
                 "--step_decay_rate 0.25 --decay_after_n_steps 3 "
                 "--weight-decay 0.999 --precompute_augment "
                 "--pallas_augment off --use_batch_stats_at_predict "
                 "--sample_foml_train_val_with_replacement --foml"),
    "losses": ("--label_smoothing 0.1 --l1 --darc1 --loss_name "
               "cross_entropy --pallas_augment on --train-shots 0 "
               "--shots 3 --feature_extractor_name efficientnet-b3 "
               "--disable_rsd_residual_connections --classes 2"),
}

JAX_ONLY = {
    "model_kwargs": set(),
    "train_loop_config": {"task_group_size", "chain_tasks",
                          "chain_eval_chunk"},
    "eval_config": {"task_chunk_size", "chain_chunk"},
}


def _parse(module, flags):
    return module.argument_parser().parse_args(shlex.split(flags))


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs,
                     tuple(a.choices) if a.choices else None, a.const)
            for a in parser._actions}


def test_parsers_have_the_same_flags():
    """Every flag: option strings, default, type, nargs, choices, const."""
    assert _actions(targs.argument_parser()) == _actions(
        jargs.argument_parser())


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_flags_parse_the_same(name):
    """run.sh's flags, no flags, and two other sets give the same value
    for every flag on both parsers."""
    assert vars(_parse(targs, FLAG_SETS[name])) == vars(
        _parse(jargs, FLAG_SETS[name]))


def _as_dict(value):
    return dataclasses.asdict(value) if dataclasses.is_dataclass(value) \
        else dict(value)


@pytest.mark.parametrize("fn", ["model_kwargs", "loss_config",
                                "opt_config", "meta_train_config",
                                "train_loop_config", "eval_config",
                                "pallas_augment_mode"])
@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_config_functions_match_jax(fn, name):
    """Each function's config equals the JAX one field by field; the fields
    only one side has are exactly those named in JAX_ONLY."""
    port = getattr(targs, fn)(_parse(targs, FLAG_SETS[name]))
    ref = getattr(jargs, fn)(_parse(jargs, FLAG_SETS[name]))
    if fn == "pallas_augment_mode":
        assert port is ref
        return
    port, ref = _as_dict(port), _as_dict(ref)
    assert set(ref) - set(port) == JAX_ONLY.get(fn, set())
    assert set(port) <= set(ref)
    assert port == {k: ref[k] for k in port}


def test_eval_config_overrides_match_jax():
    """UHO's estimate (including 0 steps) and an explicit batch override
    the flags the same way."""
    for kw in (dict(inner_iters=0), dict(inner_iters=7, inner_batch=3)):
        port = dataclasses.asdict(targs.eval_config(
            _parse(targs, RUN_SH_FLAGS), **kw))
        ref = dataclasses.asdict(jargs.eval_config(
            _parse(jargs, RUN_SH_FLAGS), **kw))
        assert port == {k: ref[k] for k in port}


def test_parameter_count_matches_jax():
    """run.sh's EfficientLab-b0 rsd (2, 4): the "Model contains N trainable
    parameters" count is the JAX package's (its shapes from eval_shape)."""
    args = _parse(jargs, RUN_SH_FLAGS)
    jmodel = JEfficientLab(**jargs.model_kwargs(args))
    key = jax.random.PRNGKey(0)
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 64, 64, 3)),
        train=True))
    model = EfficientLab(**targs.model_kwargs(_parse(targs, RUN_SH_FLAGS)))
    params = {k: p for k, p in model.named_parameters()}
    assert tree_count_params(params) == jcount(variables["params"])


def test_parameter_count_with_decoders_matches_jax():
    """run.sh's flags with `--spatial_pyramid_pooling --skip_decoding`:
    the parameter count is the JAX package's."""
    flags = RUN_SH_FLAGS + " --spatial_pyramid_pooling --skip_decoding"
    jmodel = JEfficientLab(**jargs.model_kwargs(_parse(jargs, flags)))
    key = jax.random.PRNGKey(0)
    variables = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, 64, 64, 3)),
        train=True))
    model = EfficientLab(**targs.model_kwargs(_parse(targs, flags)))
    params = {k: p for k, p in model.named_parameters()}
    assert tree_count_params(params) == jcount(variables["params"])


UNPORTED = [
    ("--mesh_tasks 2", "item 6"),
    ("--mesh_data 2", "item 6"),
    ("--rng_impl rbg", "Philox"),
]

PORTED = ["--spatial_pyramid_pooling", "--skip_decoding",
          "--spatial_pyramid_pooling --skip_decoding",
          "--save_fine_tuned_checkpoints",
          "--save_fine_tuned_checkpoints_train", "--profile_dir prof",
          "--export_serving_artifact art"]


@pytest.mark.parametrize("flags,names", UNPORTED,
                         ids=[f.split()[0] for f, _ in UNPORTED])
def test_unported_flags_raise(flags, names):
    """check_ported and main raise NotImplementedError naming the ROADMAP
    item (or, for rbg, the port's Philox generators) before any work."""
    with pytest.raises(NotImplementedError, match=names):
        targs.check_ported(_parse(targs, flags))
    with pytest.raises(NotImplementedError, match=names):
        trun.main(shlex.split(flags + " --synthetic"), device="cpu")


def test_ported_flags_pass_the_check():
    targs.check_ported(_parse(targs, RUN_SH_FLAGS))


@pytest.mark.parametrize("flags", PORTED, ids=PORTED)
def test_ported_flags_run(flags):
    """The decoders' and the exports' flags pass check_ported (they run
    through `main` in tests/test_torch_exports.py), and the model flags
    give the JAX package's model_kwargs."""
    args = _parse(targs, flags)
    targs.check_ported(args)
    assert targs.model_kwargs(args) == jargs.model_kwargs(_parse(jargs, flags))
