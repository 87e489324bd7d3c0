"""Joint (non-meta) segmentation training: the command-line entry point.

Trains EfficientLab on all training classes at once (1000-way +
background at FSS-1000 scale) with SGD and a linear LR anneal, evaluating
on held-out batches. The port of the JAX package's `cli/joint_train.py`,
with the same flags:

    python -m mliis_tpu_torch.cli.joint_train --synthetic \
        --synthetic_tasks 1000 --rsd 2 --sgd --l2 --augment \
        --batch_size 64 --epochs 1 --steps_per_epoch 12 --checkpoint DIR

It runs on the card; `main(argv, device="cpu")` runs it on the CPU.
`--pallas_augment auto|on` augments with the `fused_light_augment` kernel,
`off` with its plain version. `--mesh_data` (data-parallel training) is
not ported and raises.
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from mliis_tpu_torch.data import manifests
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.data.task_store import load_task_store
from mliis_tpu_torch.device import resolve_device
from mliis_tpu_torch.joint.trainer import (JointDataset, JointTrainConfig,
                                           JointTrainer,
                                           joint_dataset_from_task_store)
from mliis_tpu_torch.meta.inner_loop import OptimizerConfig, init_model_state
from mliis_tpu_torch.models.efficientlab import EfficientLab
from mliis_tpu_torch.utils import checkpoint as ckpt_lib


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train segmentation model via SGD.")
    add = parser.add_argument
    add('--data_dir', type=str, default=None)
    add('--joint_shard_dir', type=str, default=None,
        help='Directory of train_*/val_*/test_* joint shards and '
             'classes.txt: builds the datasets from them instead of '
             'flattening a per-task store.')
    add('--model_name', default='efficientlab')
    add('--feature_extractor_name', default='efficientnet-b0')
    add('--rsd', type=int, nargs='+', default=[2])
    add('--loss_name', default='cross_entropy')
    add('--sgd', action='store_true')
    add('--l2', action='store_true')
    add('--augment', action='store_true')
    add('--final_layer_dropout_rate', type=float, default=0.0)
    add('--image_size', type=int, default=224)
    # Accepted for compatibility: the separate-background-channel variant
    # is always trained.
    add('--seperate_background_channel', action='store_true')
    add('--fp_k_test_set', action='store_true')
    add('--test_on_val_set', action='store_true',
        help='Train on train-minus-val classes and monitor on the val '
             'split: --num_val_tasks classes popped off the sorted train '
             'class list.')
    add('--num_val_tasks', type=int, default=50)
    add('--restore_efficient_net_weights_from', type=str, default=None)
    add('--batch_size', default=64, type=int)
    add('--epochs', default=200, type=int)
    add('--steps_per_epoch', type=int, default=None)
    add('--learning_rate', default=0.005, type=float)
    add('--final_learning_rate', default=5e-7, type=float)
    add('--label_smoothing', default=0.0, type=float)
    add('--val_batches', default=20, type=int)
    add('--pretrained', action='store_true', default=False)
    add('--eval_interval', default=2, type=int)
    add('--seed', default=0, type=int)
    add('--checkpoint', type=str,
        default=os.path.join(tempfile.gettempdir(), 'model_checkpoint'))
    add('--synthetic', action='store_true')
    add('--synthetic_tasks', type=int, default=8)
    add('--pallas_augment', choices=['auto', 'on', 'off'], default='auto',
        help='auto and on: the fused_light_augment kernel; off: its plain '
             'version.')
    add('--mesh_data', type=int, default=0,
        help='Data-parallel training over this many devices: not ported.')
    return parser.parse_args(argv)


def _datasets(args):
    """(train, test) JointDatasets as the JAX CLI builds them."""
    if args.joint_shard_dir:
        from mliis_tpu_torch.data.convert import load_joint_shards
        tr_imgs, tr_lbls, class_names = load_joint_shards(
            args.joint_shard_dir, "train", args.image_size)
        eval_split = "val" if args.test_on_val_set else "test"
        te_imgs, te_lbls, _ = load_joint_shards(
            args.joint_shard_dir, eval_split, args.image_size)
        if not te_imgs.shape[0]:
            raise FileNotFoundError("no {}_* shards in {}".format(
                eval_split, args.joint_shard_dir))
        return (JointDataset(tr_imgs, tr_lbls.astype(np.int32), class_names),
                JointDataset(te_imgs, te_lbls.astype(np.int32), class_names))
    if args.synthetic:
        store = make_synthetic_store(num_tasks=args.synthetic_tasks,
                                     examples_per_task=10,
                                     image_size=args.image_size,
                                     seed=args.seed)
        n_test = max(args.synthetic_tasks // 4, 1)
        test_store = store.subset(range(n_test))
        train_store = store.subset(range(n_test, store.num_tasks))
        if args.test_on_val_set:
            train_names, val_names = manifests.split_train_test_tasks(
                train_store.names, max(min(args.num_val_tasks,
                                           train_store.num_tasks - 1), 1),
                reproducible_splits=True)
            test_store = train_store.subset_by_names(val_names)
            train_store = train_store.subset_by_names(train_names)
        all_classes = sorted(store.names)
    else:
        store = load_task_store(args.data_dir, image_size=args.image_size)
        train_classes, test_classes = (manifests.TRAIN_TASK_IDS,
                                       manifests.TEST_TASK_IDS)
        all_classes = sorted(list(train_classes) + list(test_classes))
        if args.fp_k_test_set:
            test_classes = manifests.FP_K_TEST_TASK_IDS
            train_classes = [x for x in all_classes if x not in test_classes]
        manifests.assert_train_test_split(train_classes, test_classes)
        present = set(store.names)
        train_names = [n for n in train_classes if n in present]
        if args.test_on_val_set:
            train_names, test_classes = manifests.split_train_test_tasks(
                train_names, max(min(args.num_val_tasks,
                                     len(train_names) - 1), 1),
                reproducible_splits=True)
        train_store = store.subset_by_names(train_names)
        test_store = store.subset_by_names(
            [n for n in test_classes if n in present])
    return (joint_dataset_from_task_store(train_store, all_classes),
            joint_dataset_from_task_store(test_store, all_classes))


def main(argv=None, device=None):
    """Run the training; returns the trained ModelState. `device` defaults
    to cuda."""
    start = time.time()
    args = parse_args(argv)
    if args.mesh_data:
        raise NotImplementedError(
            "--mesh_data: the data-parallel joint trainer is not ported "
            "(ROADMAP.md, 'data-parallel joint trainer with parallel/')")
    dev = resolve_device(device)

    t0 = time.time()
    train_ds, test_ds = _datasets(args)
    print("datasets: {} train and {} test examples built in {:.2f} s".format(
        train_ds.num_examples, test_ds.num_examples, time.time() - t0))
    num_classes = train_ds.num_classes
    print("building dataset with labels with {} mask channels".format(
        num_classes + 1))

    model = EfficientLab(
        n_classes=num_classes, separate_background_channel=True,
        feature_extractor_name=args.feature_extractor_name,
        rsd=tuple(args.rsd) if args.rsd else None,
        final_layer_dropout_rate=args.final_layer_dropout_rate)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    model.to(dev)
    opt_cfg = OptimizerConfig(name="sgd" if args.sgd else "adam")
    state = init_model_state(model, opt_cfg)
    if args.restore_efficient_net_weights_from:
        state, _ = ckpt_lib.restore_checkpoint(
            args.restore_efficient_net_weights_from, state,
            filter_to_scopes=[args.feature_extractor_name.replace("-", "_")])

    config = JointTrainConfig(
        batch_size=args.batch_size, epochs=args.epochs,
        steps_per_epoch=args.steps_per_epoch,
        learning_rate=args.learning_rate,
        final_learning_rate=args.final_learning_rate,
        label_smoothing=args.label_smoothing, augment=args.augment,
        l2=args.l2, eval_interval=args.eval_interval,
        val_batches=args.val_batches,
        use_pallas_augment={'auto': None, 'on': True,
                            'off': False}[args.pallas_augment])
    trainer = JointTrainer(model, train_ds, test_ds, config, opt_cfg,
                           device=dev)
    state = trainer.train(state, args.checkpoint,
                          torch.Generator(device=dev).manual_seed(
                              args.seed + 1))
    print("Finished training")
    print("Experiment took {} hours".format((time.time() - start) / 3600.0))
    return state


if __name__ == "__main__":
    main()
