"""Meta-trains and evaluates image segmentation models: the entry point.

The port of the JAX package's `cli/run_metasegnet.py`, with the same flags
(`cli/args.py`) and protocol: build the model -> select the datasets
(FSS-1000 shards with the manifests' split, the FP-k holdout, the k-shot
synonym tasks, or a synthetic store) -> restore (`--pretrained`) or
meta-train (`meta/train.train_gecko`) -> optionally UHO on the val set and
a meta-fine-tune on train+val -> the k-shot curves, or the train/test
evaluation with the grep line and meta-test_results.json:

    python -m mliis_tpu_torch.cli.run_metasegnet --synthetic \
        --image_size 224 --rsd 2 4 --l2 --foml --foml-tail 5 ... \
        --checkpoint DIR

It runs on the card; `main(argv, device="cpu")` runs it on the CPU. Every
random draw comes from one `torch.Generator` on that device, seeded from
`--seed` (the weights from a CPU generator with the same seed). As in the
JAX driver (mliis_tpu/cli/run_metasegnet.py:70-73, 248-294),
`--profile_dir` traces the whole run, the final evaluations write the
fine-tuned checkpoints (`--save_fine_tuned_checkpoints_train` on the train
set, `--save_fine_tuned_checkpoints` on the test set, both under
`--save_fine_tuned_checkpoints_dir`), and `--export_serving_artifact` is
written after the results JSON. Flags of features that are not ported
raise NotImplementedError naming their ROADMAP.md item
(`args.check_ported`).
"""
import dataclasses
import datetime
import json
import os
import random

import numpy as np
import torch

from mliis_tpu_torch.cli import args as args_lib
from mliis_tpu_torch.data import manifests
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.data.task_store import (TaskStore,
                                             assert_train_test_split,
                                             load_task_store, split_fss_1000,
                                             union_tasks_by_synonyms,
                                             validate_datasets)
from mliis_tpu_torch.device import resolve_device
from mliis_tpu_torch.meta.evaluate import GeckoEvaluator, evaluate_gecko
from mliis_tpu_torch.meta.inner_loop import init_model_state
from mliis_tpu_torch.meta.kshot import run_k_shot_learning_curves_experiment
from mliis_tpu_torch.meta.train import train_gecko
from mliis_tpu_torch.meta.uho_eval import (EarlyStoppingEvaluator,
                                           optimize_update_hyperparams)
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.ops.meta_math import tree_count_params
from mliis_tpu_torch.utils import checkpoint as ckpt_lib
from mliis_tpu_torch.utils import profiling
from mliis_tpu_torch.utils.export import save_serving_artifact


def load_datasets(args):
    """Returns (train_store, val_store, test_store)."""
    if args.synthetic:
        store = make_synthetic_store(num_tasks=args.synthetic_tasks,
                                     examples_per_task=10,
                                     image_size=args.image_size,
                                     seed=args.seed)
        n_test = max(args.synthetic_tasks // 4, 1)
        test = store.subset(range(n_test))
        rest = store.subset(range(n_test, store.num_tasks))
        val = None
        if args.num_val_tasks:
            val = rest.subset(range(args.num_val_tasks))
            rest = rest.subset(range(args.num_val_tasks, rest.num_tasks))
        return rest, val, test

    store = load_task_store(args.data_dir, image_size=args.image_size)
    if args.run_k_shot_learning_curves_experiment:
        return None, None, union_tasks_by_synonyms(store)
    test_ids = manifests.FP_K_TEST_TASK_IDS if args.fp_k_test_set else None
    return split_fss_1000(store, num_val_tasks=args.num_val_tasks,
                          test_task_ids=test_ids)


def main(argv=None, device=None):
    """Run the protocol on `device` (default cuda)."""
    start_time = datetime.datetime.now()
    print("Experiment started at: {}".format(start_time))
    args = args_lib.argument_parser().parse_args(argv)
    args_lib.check_ported(args)
    dev = resolve_device(device)
    if args.profile_dir:
        with profiling.trace(args.profile_dir, dev) as path:
            state = _main_impl(args, dev, start_time)
        print("Wrote the profiler trace to {}".format(path))
        return state
    return _main_impl(args, dev, start_time)


def _main_impl(args, dev, start_time):
    if args.optimize_update_hyperparms_on_val_set and not args.num_val_tasks:
        raise ValueError(
            "Must specify num_val_tasks > 0 to optimize update hyperparams.")
    random.seed(args.seed)
    generator = torch.Generator(device=dev).manual_seed(args.seed)

    print("Defining model architecture:")
    loss_cfg = args_lib.loss_config(args)
    opt_cfg = args_lib.opt_config(args)
    model = EfficientLab(**args_lib.model_kwargs(args))
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    model.to(dev)
    state = init_model_state(model, opt_cfg)
    print("Model contains {} trainable parameters.".format(
        tree_count_params(state.params)))
    print("Meta-learning with algorithm:")
    print("FOMAML" if args.foml else "Reptile")

    print("Setting up meta-learning dataset")
    train_store, val_store, test_store = load_datasets(args)
    print("Found {} testing tasks.".format(test_store.num_tasks))
    if train_store is not None:
        print("Found {} training tasks.".format(train_store.num_tasks))
    validate_datasets(train_store, val_store, test_store,
                      pretrained=args.pretrained,
                      run_k_shot_experiment=(
                          args.run_k_shot_learning_curves_experiment),
                      eval_val_tasks=args.eval_val_tasks)
    if not args.run_k_shot_learning_curves_experiment:
        assert_train_test_split(
            train_store, test_store,
            check_image_hashes=args.test_train_test_split)
        if val_store is not None:
            assert_train_test_split(
                val_store, test_store,
                check_image_hashes=args.test_train_test_split)

    if args.restore_efficient_net_weights_from and not args.pretrained:
        print("Restoring backbone from {}".format(
            args.restore_efficient_net_weights_from))
        state, _ = ckpt_lib.restore_checkpoint(
            args.restore_efficient_net_weights_from, state,
            filter_to_scopes=[args.feature_extractor_name.replace("-", "_")])

    if not args.pretrained:
        print("Meta-training...")
        if args.continue_training_from_checkpoint:
            state, _ = ckpt_lib.restore_checkpoint(
                args.continue_training_from_checkpoint, state)
            print("Continuing meta-training from checkpoint.")
        state = train_gecko(
            model, state, train_store, val_store or test_store,
            args.checkpoint, loss_cfg, opt_cfg,
            args_lib.meta_train_config(args), args_lib.train_loop_config(args),
            generator, device=dev)
    elif args.do_not_restore_final_layer_weights:
        print("Restoring from checkpoint (without final layer): {}".format(
            args.checkpoint))
        state, _ = ckpt_lib.restore_checkpoint(
            args.checkpoint, state, filter_out_scope="final_layer_weights")
    else:
        print("Restoring from checkpoint: {}".format(args.checkpoint))
        state, _ = ckpt_lib.restore_checkpoint(args.checkpoint, state)

    eval_lr = None  # None: the --learning-rate flag
    eval_inner_iters = args.eval_iters

    if args.optimize_update_hyperparms_on_val_set:
        print("Optimizing the update routine hyperparams on the val set")
        if val_store is None or val_store.num_tasks == 0:
            raise ValueError("UHO needs a val set with tasks")
        es_eval = EarlyStoppingEvaluator(
            model, loss_cfg, opt_cfg, val_store, num_shots=args.shots,
            replacement=args.replacement, augment=args.augment,
            weight_decay_rate=args.weight_decay,
            pallas_augment=args_lib.pallas_augment_mode(args), device=dev)
        estimated_lr, estimated_steps = optimize_update_hyperparams(
            es_eval, state, generator, min_steps=args.min_steps,
            max_steps=args.max_steps,
            num_train_val_data_splits_to_sample_per_config=(
                1 if args.fss_1000 else 4),
            num_configs_to_sample=args.num_configs_to_sample,
            lr_search_range_low=args.lr_search_range_low,
            lr_search_range_high=args.lr_search_range_high,
            drop_rate_search_range_low=args.drop_rate_search_range_low,
            drop_rate_search_range_high=args.drop_rate_search_range_high,
            aug_rate_search_range_low=args.aug_rate_search_range_low,
            aug_rate_search_range_high=args.aug_rate_search_range_high,
            batch_size_search_range_low=args.batch_size_search_range_low,
            batch_size_search_range_high=args.batch_size_search_range_high,
            serially_eval_all_tasks=args.serially_eval_all_test_tasks,
            eval_tasks_with_median_early_stopping_iterations=(
                args.eval_tasks_with_median_early_stopping_iterations),
            save_dir=args.checkpoint,
            results_csv_name=args.uho_results_csv_name,
            num_shots=args.shots, estimator=args.uho_estimator)
        eval_lr, eval_inner_iters = estimated_lr, estimated_steps
        print("UHO estimated lr={} steps={}".format(eval_lr, eval_inner_iters))

        if args.meta_fine_tune_steps_on_train_val > 0:
            print("Meta-fine-tuning for {} steps with optimized "
                  "hyperparameters.".format(
                      args.meta_fine_tune_steps_on_train_val))
            merged = TaskStore(
                np.concatenate([train_store.images, val_store.images]),
                np.concatenate([train_store.masks, val_store.masks]),
                np.concatenate([train_store.counts, val_store.counts]),
                train_store.names + val_store.names)
            ft_loop = dataclasses.replace(
                args_lib.train_loop_config(args),
                meta_iters=args.meta_fine_tune_steps_on_train_val,
                meta_step_size=args.meta_step_final,
                lr=estimated_lr)
            ft_meta = dataclasses.replace(args_lib.meta_train_config(args),
                                          inner_iters=estimated_steps)
            state = train_gecko(
                model, state, merged, test_store,
                os.path.join(args.checkpoint,
                             "fine-tuned_on_train_val_with_optimized_"
                             "update_hyperparams"),
                loss_cfg, opt_cfg, ft_meta, ft_loop, generator, device=dev)

    lr = eval_lr if eval_lr is not None else args.learning_rate
    if args.run_k_shot_learning_curves_experiment:
        kshot_kwargs = {}
        if args.k_shot_k_range:
            kshot_kwargs["k_range"] = args.k_shot_k_range
        run_k_shot_learning_curves_experiment(
            model, loss_cfg, opt_cfg, state, test_store, generator,
            num_samples=args.eval_samples,
            iter_range=args.k_shot_iter_range,
            eval_inner_batch_size=args.eval_batch,
            eval_inner_iters=eval_inner_iters, lr=lr,
            aug_rate=args.aug_rate,
            pallas_augment=args_lib.pallas_augment_mode(args), device=dev,
            **kshot_kwargs)
        return state

    eval_cfg = args_lib.eval_config(args, inner_iters=eval_inner_iters)
    print('Evaluating {}-shot learning on training tasks.'.format(args.shots))
    mean_train_iou = float("nan")
    if train_store is not None:
        train_evaluator = GeckoEvaluator(model, loss_cfg, opt_cfg, eval_cfg,
                                         train_store, device=dev)
        mean_train_iou, _ = evaluate_gecko(
            train_evaluator, state, generator, lr=lr,
            num_samples=args.eval_samples, serially_eval_all_tasks=False,
            num_tasks_to_sample=1, aug_rate=args.aug_rate,
            save_fine_tuned_checkpoints=args.save_fine_tuned_checkpoints_train,
            save_fine_tuned_checkpoints_dir=(
                args.save_fine_tuned_checkpoints_dir))

    if args.eval_val_tasks:
        target_store, test_set_string = val_store, "val"
    else:
        target_store, test_set_string = test_store, "test"
    print('Evaluating {}-shot learning on meta-{} tasks.'.format(
        args.shots, test_set_string))
    evaluator = GeckoEvaluator(model, loss_cfg, opt_cfg, eval_cfg,
                               target_store, device=dev)
    mean_test_iou, task_name_iou_map = evaluate_gecko(
        evaluator, state, generator, lr=lr, num_samples=args.eval_samples,
        serially_eval_all_tasks=args.serially_eval_all_test_tasks,
        num_tasks_to_sample=1, aug_rate=args.aug_rate,
        save_fine_tuned_checkpoints=args.save_fine_tuned_checkpoints,
        save_fine_tuned_checkpoints_dir=args.save_fine_tuned_checkpoints_dir)

    print("Evaluated meta-{} tasks:".format(test_set_string))
    print(task_name_iou_map)
    if train_store is not None:
        print("Mean meta-train IoU: {}".format(mean_train_iou))
    # Do NOT change this print (it's used to grep logs):
    print("Mean IoU over all meta-test tasks: {}".format(mean_test_iou))

    os.makedirs(args.checkpoint, exist_ok=True)
    results_path = os.path.join(args.checkpoint, "meta-test_results.json")
    with open(results_path, "w") as f:
        json.dump(task_name_iou_map, f)
    print("Wrote results to {}".format(results_path))

    if args.export_serving_artifact:
        save_serving_artifact(args.export_serving_artifact, model, state,
                              args.image_size)
        print("Exported serving artifact to {}".format(
            args.export_serving_artifact))

    end_time = datetime.datetime.now()
    print("Experiment finished at: {}, taking {}".format(
        end_time, end_time - start_time))
    return state


if __name__ == "__main__":
    main()
