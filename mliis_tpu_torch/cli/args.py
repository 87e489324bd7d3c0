"""Command-line arguments of the meta-training entry point.

The port of the JAX package's `cli/args.py`: the same flags, defaults and
`choices` (the reference's meta_learners/args.py and the JAX package's
extensions), and the same functions from the flat namespace to the typed
configs: `model_kwargs`, `pallas_augment_mode`, `loss_config`,
`opt_config`, `meta_train_config`, `train_loop_config` and `eval_config`.

`--rng_impl rbg` is parsed and then refused by `check_ported`: the port
draws with torch's Philox generators. `--mesh_tasks N` and `--mesh_data M`
shard the meta-training and evaluation over N x M ranks, one process a
rank under `torchrun --nproc_per_node` (parallel/mesh.py). The
execution-strategy flags select what they select in the JAX package:
with none of them the meta-batch runs on a task axis
(`learners.make_train_step`), `--task_group_size g` runs it in task
groups of g (`make_microbatched_train_step`), `--chain_tasks` one task
after another (`make_chained_train_step`; with `--mesh_tasks`, each
rank's slots), and the evaluations run `--task_chunk_size` tasks at a
time on a task axis, or one after another with `--chain_eval_chunk`.
The strategies make the same draws and compute the same function, up to
float rounding.
"""
import argparse

from mliis_tpu_torch.meta.evaluate import EvalConfig
from mliis_tpu_torch.meta.inner_loop import LossConfig, OptimizerConfig
from mliis_tpu_torch.meta.learners import MetaTrainConfig
from mliis_tpu_torch.meta.train import TrainLoopConfig

SUPPORTED_MODELS = {"efficientlab"}
SUPPORTED_LR_SCHEDULERS = {"cosine_anneal", "fixed", "constant", "step",
                           "step_decay"}


def argument_parser():
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    add = parser.add_argument
    # Parsed-but-unused in the reference too (args.py:21-24 have no reader
    # outside the parser); accepted for CLI compatibility.
    add('--fine-tune-task', type=str, default=None)
    add('--fine-tuned-checkpoint', type=str, default=None)
    add('--pretrained', action='store_true', default=False,
        help='Continue training or evaluate a pre-trained model.')
    add('--seed', default=0, type=int)
    add('--checkpoint', default='model_checkpoint')
    add('--classes', default=1, type=int)
    add('--shots', default=5, type=int,
        help='number of examples per class at meta-test time')
    add('--train-shots', default=5, type=int)
    add('--inner-batch', default=8, type=int)
    add('--inner-iters', default=8, type=int)
    add('--replacement', action='store_true')
    add('--learning-rate', default=1e-3, type=float)
    add('--meta-step', default=0.1, type=float)
    add('--meta-step-final', default=0.1, type=float)
    add('--meta-batch', default=5, type=int)
    add('--meta-iters', default=400000, type=int)
    add('--eval-batch', default=8, type=int)
    add('--eval-iters', default=4, type=int)
    add('--eval-samples', default=200, type=int)
    add('--eval-interval', default=10, type=int)
    add('--weight-decay', default=1, type=float)
    add('--transductive', action='store_true')
    add('--foml', action='store_true')
    add('--foml-tail', default=None, type=int)
    add('--sgd', action='store_true')
    add('--data-dir', help='Path to directory housing meta-learning data.')
    add('--loss_name', default='cross_entropy',
        help='cross_entropy, soft_iou, or bce_dice')
    add('--save_fine_tuned_checkpoints', action='store_true')
    add('--save_fine_tuned_checkpoints_train', action='store_true')
    add('--save_fine_tuned_checkpoints_dir',
        default='/tmp/checkpoints/fine-tuned')
    add('--model_name', default='efficientlab')
    add('--restore_efficient_net_weights_from', type=str, default=None)
    add('--spatial_pyramid_pooling', action='store_true')
    add('--skip_decoding', action='store_true')
    add('--rsd', type=int, nargs='+')
    add('--feature_extractor_name', type=str, default='efficientnet-b0')
    # Vestigial U-Net hyperparameters (args.py:51-53,62 in the reference,
    # threaded into model_kwargs at :156-157 but consumed by no supported
    # model — EfficientLab ignores them). Accepted for compatibility so a
    # reference user's saved command line parses; no behavioral effect.
    add('--n_unet_encoding_stacks', type=int, default=4,
        help='Accepted for reference CLI compatibility; no effect '
             '(vestigial U-Net parameter).')
    add('--start_num_feature_maps_power', type=int, default=5,
        help='Accepted for reference CLI compatibility; no effect '
             '(vestigial U-Net parameter).')
    add('--learning_rate_scheduler', type=str, default='fixed',
        choices=sorted(SUPPORTED_LR_SCHEDULERS))
    add('--step_decay_rate', type=float, default=0.5)
    add('--decay_after_n_steps', type=int, default=5)
    add('--l2', action='store_true')
    add('--l1', action='store_true')
    add('--darc1', action='store_true')
    add('--augment', action='store_true')
    add('--final_layer_dropout_rate', type=float, default=0.0)
    add('--image_size', type=int, default=320)
    add('--label_smoothing', default=0.0, type=float)
    add('--continue_training_from_checkpoint', default=None)
    add('--fss_1000', action='store_true',
        help='FSS-1000 dataset: one train/val split sampled per UHO config '
             'instead of four (run_metasegnet.py:142).')
    add('--num_val_tasks', type=int, default=0)
    add('--eval_val_tasks', action='store_true')
    add('--serially_eval_all_test_tasks', action='store_true')
    add('--optimize_update_hyperparms_on_val_set', action='store_true')
    add('--num_configs_to_sample', default=100, type=int)
    add('--meta_fine_tune_steps_on_train_val', type=int, default=0)
    # In the reference this sets skopt's log base for the log-uniform priors
    # (args.py:95 -> base=). A log-uniform distribution is base-invariant, so
    # it is accepted for compatibility with no behavioral effect.
    add('--uho_outer_iters', type=int, default=2)
    add('--lr_search_range_low', default=0.0005, type=float)
    add('--lr_search_range_high', default=0.05, type=float)
    add('--drop_rate_search_range_low', default=0.2, type=float)
    add('--drop_rate_search_range_high', default=0.2, type=float)
    add('--aug_rate_search_range_low', default=0.5, type=float)
    add('--aug_rate_search_range_high', default=0.5, type=float)
    add('--batch_size_search_range_low', default=8, type=int)
    add('--batch_size_search_range_high', default=8, type=int)
    add('--run_k_shot_learning_curves_experiment', action='store_true')
    add('--fp_k_test_set', action='store_true')
    add('--disable_rsd_residual_connections', action='store_true')
    add('--do_not_restore_final_layer_weights', action='store_true')
    add('--eval_tasks_with_median_early_stopping_iterations',
        action='store_true')
    add('--min_steps', type=int, default=0)
    add('--max_steps', type=int, default=80)
    add('--k_shot_iter_range', nargs='+', type=int, default=None)
    add('--k_shot_k_range', nargs='+', type=int, default=None,
        help='Override the k values for the k-shot learning-curve '
             'experiment (default 1 5 10 50 100 200 400, eval.py:188).')
    add('--sample_foml_train_val_with_replacement', action='store_true')
    add('--aug_rate', type=float, default=0.5)
    add('--uho_results_csv_name', type=str,
        default='val-set_hyper_param_search_results.csv')
    add('--uho_estimator', default='GP', type=str)
    add('--use_batch_stats_at_predict', action='store_true',
        help='Legacy no-is_training-flag prediction mode: BN uses batch '
             'statistics at predict time, so transductive genuinely leaks '
             'across the query batch (reptile.py:500-524).')
    add('--test_train_test_split', action='store_true',
        help='Also assert sha-256 image-level train/test disjointness '
             '(metaseg.py:305-310; name-level disjointness is always '
             'checked).')
    # --- Extensions of the JAX package ---
    add('--synthetic', action='store_true',
        help='Use synthetic tasks instead of FSS-1000 shards (for smoke '
             'tests / environments without the dataset).')
    add('--synthetic_tasks', type=int, default=16)
    add('--task_chunk_size', type=int, default=2,
        help='Evaluation tasks adapted and predicted (and UHO\'s '
             'early-stopping traces run) together on a task axis (one '
             'augmentation launch and one forward and backward an inner '
             'step for the chunk).')
    add('--pallas_augment', choices=['auto', 'on', 'off'], default='auto',
        help='auto and on: the augmentation kernels (full_pass, or '
             'cheap_pass on the split route); off: their plain PyTorch '
             'versions, on any device.')
    add('--precompute_augment', action='store_true',
        help='Augment every inner step\'s batch (bf16-staged) before the '
             'adaptation loop instead of inside each step.')
    add('--task_group_size', type=int, default=0,
        help='Run the meta-batch in groups of this many tasks, each group '
             'on a task axis, combined with task-count weights (0: the '
             'whole meta-batch on one task axis).')
    add('--chain_tasks', action='store_true',
        help='Run the meta-batch\'s tasks one after another (one task\'s '
             'activations at a time); with --mesh_tasks, each rank\'s '
             'slots.')
    add('--chain_eval_chunk', action='store_true',
        help='Run each evaluation chunk\'s tasks (and the early-stopping '
             'traces) one after another instead of on a task axis; under '
             'a mesh UHO\'s evaluator drops it, as the JAX CLI does.')
    add('--mesh_tasks', type=int, default=0,
        help='Shard the meta-batch and the evaluations\' tasks over this '
             'many ranks along a "task" mesh axis: one process a rank, '
             'launched with torchrun --nproc_per_node (mesh_tasks x '
             'max(1, mesh_data)); 1 runs a world of 1 without torchrun.')
    add('--mesh_data', type=int, default=0,
        help='With --mesh_tasks: meta-train on a (mesh_tasks, mesh_data) '
             'mesh, every inner batch split over the data axis with '
             'sync-BN; evaluation shards tasks over all the ranks.')
    add('--rng_impl', choices=['threefry', 'rbg'], default='threefry',
        help='threefry: the port\'s Philox generators; rbg is not '
             'available.')
    add('--profile_dir', type=str, default=None,
        help='Write a torch.profiler Chrome trace (host and CUDA activity, '
             'the PhaseTimer phases as ranges) of the whole run into this '
             'directory.')
    add('--export_serving_artifact', type=str, default=None,
        help='After the evaluation, write the eval-mode forward of the '
             'final model (its state in the program) to this path as a '
             'torch.export artifact (.pt2) with a dynamic batch.')
    return parser


def check_ported(args) -> None:
    """Raise NotImplementedError for `--rng_impl rbg`, which the port does
    not have."""
    if args.rng_impl != "threefry":
        raise NotImplementedError(
            "--rng_impl {}: the port draws with torch's Philox generators "
            "and has no rbg".format(args.rng_impl))


def model_kwargs(args) -> dict:
    """EfficientLab's keyword arguments (float32 compute, as the JAX CLI
    builds it)."""
    name = args.model_name.lower()
    if name not in SUPPORTED_MODELS:
        raise ValueError("Model name must be in {} but is {}".format(
            SUPPORTED_MODELS, name))
    return dict(
        n_classes=args.classes,
        feature_extractor_name=args.feature_extractor_name,
        rsd=tuple(args.rsd) if args.rsd else None,
        spatial_pyramid_pooling=args.spatial_pyramid_pooling,
        skip_decoding=args.skip_decoding,
        disable_rsd_residual_connections=args.disable_rsd_residual_connections,
        final_layer_dropout_rate=args.final_layer_dropout_rate,
    )


def pallas_augment_mode(args):
    """--pallas_augment {auto,on,off} -> None/True/False: None and True take
    the kernels, False their plain versions."""
    return {'auto': None, 'on': True, 'off': False}[args.pallas_augment]


def loss_config(args) -> LossConfig:
    return LossConfig(
        label_smoothing=args.label_smoothing,
        dice="dice" in args.loss_name,
        binary_iou_loss=True,
        l2=args.l2, l1=args.l1, darc1=args.darc1)


def opt_config(args) -> OptimizerConfig:
    return OptimizerConfig(name="sgd" if args.sgd else "adam")


def meta_train_config(args) -> MetaTrainConfig:
    return MetaTrainConfig(
        num_shots=args.train_shots or args.shots,
        inner_batch_size=args.inner_batch,
        inner_iters=args.inner_iters,
        replacement=args.replacement,
        meta_batch_size=args.meta_batch,
        foml=args.foml,
        tail_shots=args.foml_tail,
        sample_train_val_with_replacement=(
            args.sample_foml_train_val_with_replacement),
        augment=args.augment,
        aug_rate=args.aug_rate,
        weight_decay_rate=args.weight_decay,
        precompute_augment=args.precompute_augment,
        pallas_augment=pallas_augment_mode(args),
        lr_scheduler=args.learning_rate_scheduler,
        lr_decay_rate=args.step_decay_rate,
        lr_decay_after_n_steps=args.decay_after_n_steps)


def train_loop_config(args) -> TrainLoopConfig:
    return TrainLoopConfig(
        meta_iters=args.meta_iters,
        meta_step_size=args.meta_step,
        meta_step_size_final=args.meta_step_final,
        eval_interval=args.eval_interval,
        eval_inner_batch_size=args.eval_batch,
        eval_inner_iters=args.eval_iters,
        num_eval_shots=args.shots,
        lr=args.learning_rate,
        transductive=args.transductive,
        aug_rate=args.aug_rate,
        task_group_size=args.task_group_size or None,
        chain_tasks=args.chain_tasks,
        chain_eval_chunk=args.chain_eval_chunk,
        mesh_tasks=args.mesh_tasks,
        mesh_data=args.mesh_data)


def eval_config(args, inner_iters=None, inner_batch=None) -> EvalConfig:
    return EvalConfig(
        num_shots=args.shots,
        test_shots=5,
        # `is None`: UHO's early stopping may estimate 0 steps, which must
        # not fall back to the flag.
        inner_batch_size=(args.eval_batch if inner_batch is None
                          else inner_batch),
        inner_iters=(args.eval_iters if inner_iters is None
                     else inner_iters),
        replacement=args.replacement,
        transductive=args.transductive,
        augment=args.augment,
        precompute_augment=args.precompute_augment,
        pallas_augment=pallas_augment_mode(args),
        weight_decay_rate=args.weight_decay,
        lr_scheduler=args.learning_rate_scheduler,
        lr_decay_rate=args.step_decay_rate,
        lr_decay_after_n_steps=args.decay_after_n_steps,
        use_batch_stats_at_predict=args.use_batch_stats_at_predict,
        task_chunk_size=args.task_chunk_size,
        chain_chunk=args.chain_eval_chunk)
