"""The port's sharded drivers end to end: `train_gecko` on a 2x2 (task,
data) mesh and both CLIs (`run_metasegnet --mesh_tasks 2 --mesh_data 2`,
`joint_train --mesh_data 4`) on a spawned gloo world of 4
(tests/torch_mesh_worker.py), each rank with its own output directory;
then the guards that need no world, and a world of 1 that starts by
itself."""
import os

import numpy as np
import pytest
import torch

from mliis_tpu_torch.cli import run_metasegnet as trun
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.meta import learners as tlr
from mliis_tpu_torch.meta import train as ttrain
from mliis_tpu_torch.parallel import mesh as mesh_lib
from tests import torch_mesh_worker as worker
from tests.torch_tiny_model import TorchTinySeg

STORE = dict(num_tasks=8, examples_per_task=10, image_size=16, seed=0)
CFG = dict(num_shots=6, inner_batch_size=4, inner_iters=2, meta_batch_size=3,
           foml=True, tail_shots=2, augment=True, aug_rate=0.5)
LOOP = dict(meta_iters=2, eval_interval=1, num_tasks_to_eval=2,
            eval_inner_iters=2, eval_inner_batch_size=4, num_eval_shots=4,
            mesh_tasks=2, mesh_data=2, save_checkpoint_every_n_meta_iters=100)
CLI = ("--synthetic --synthetic_tasks 6 --image_size 32 --rsd 2 --sgd "
       "--loss_name bce_dice --inner-batch 4 --train-shots 6 --inner-iters 2 "
       "--meta-iters 1 --meta-batch 2 --eval-interval 2 --eval-samples 1 "
       "--eval-batch 4 --eval-iters 2 --transductive --foml --foml-tail 2 "
       "--augment --mesh_tasks 2 --mesh_data 2")
JOINT_CLI = ("--synthetic --synthetic_tasks 8 --image_size 16 --rsd 2 --sgd "
             "--augment --l2 --batch_size 4 --epochs 1 --steps_per_epoch 2 "
             "--eval_interval 1 --val_batches 1 --mesh_data 4")


def _model_state():
    """TorchTinySeg with weights drawn from seed 0, and its state."""
    model = TorchTinySeg()
    gen = torch.Generator().manual_seed(0)
    for module in model.modules():
        if module is not model and hasattr(module, "reset_parameters"):
            module.reset_parameters(gen)
    return model, til.init_model_state(model, til.OptimizerConfig("sgd"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("drivers")
    model, _ = _model_state()
    case = dict(name="drivers", kind="drivers", out=str(out),
                state_dict=model.state_dict(), store=STORE, cfg=CFG,
                loop=LOOP, cli=CLI, joint_cli=JOINT_CLI)
    return worker.spawn(4, str(out), [case])["drivers"]


@pytest.mark.parametrize("driver", ["gecko", "cli", "joint"])
def test_sharded_drivers_run_alike_on_every_rank(ranks, driver):
    """train_gecko (2x2, FOMAML* with augmentation and interval
    evaluations), the meta-training CLI (2x2, its training and final
    evaluations) and the joint CLI (4 data ranks): each runs to its end,
    and every rank holds the same finite params."""
    first = ranks[0][driver]
    for r in ranks:
        for k, v in r[driver].items():
            assert torch.isfinite(v).all(), k
            np.testing.assert_allclose(v.numpy(), first[k].numpy(),
                                       atol=1e-6, err_msg=k)


def test_rank_zero_alone_writes(ranks):
    """Rank 0 wrote the checkpoints, metrics, phase timings and results of
    all three runs; the other ranks wrote nothing."""
    files = ranks[0]["files"]
    for expected in ("gecko/model.ckpt-1.npz", "gecko/phase_timings.jsonl",
                     "gecko/train_metrics.jsonl", "cli/model.ckpt-0.npz",
                     "cli/meta-test_results.json", "joint/model.ckpt-0.npz",
                     "joint/joint_train_metrics.jsonl"):
        assert expected in files, files
    for r in ranks[1:]:
        assert r["files"] == []


def test_mesh_data_without_mesh_tasks_raises(tmp_path):
    model, state = _model_state()
    store = make_synthetic_store(**STORE)
    with pytest.raises(ValueError, match="mesh_data > 1 requires"):
        ttrain.train_gecko(model, state, store, store, str(tmp_path),
                           til.LossConfig(), til.OptimizerConfig("sgd"),
                           tlr.MetaTrainConfig(**CFG),
                           ttrain.TrainLoopConfig(meta_iters=1, mesh_tasks=0,
                                                  mesh_data=2),
                           torch.Generator(), device="cpu")
    with pytest.raises(SystemExit, match="--mesh_data requires"):
        trun.main(["--synthetic", "--mesh_data", "2"], device="cpu")


def test_larger_mesh_without_torchrun_raises(monkeypatch):
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        mesh_lib.make_task_mesh(2, "cpu")


def test_world_of_one_starts_itself(tmp_path, monkeypatch):
    """A mesh of 1 without torchrun starts a world of 1 on a FileStore under
    the given directory, and its sharded step with its slots chained
    (`chain_local`) is the chained step, bit for bit; the world ends with
    the block."""
    for name in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    model, state = _model_state()
    cfg = tlr.MetaTrainConfig(**CFG)
    images, masks, counts = make_synthetic_store(**STORE).to_torch("cpu")
    ref = tlr.make_chained_train_step(model, til.LossConfig(),
                                      til.OptimizerConfig("sgd"), cfg)(
        state, images, masks, tlr.draw_meta_step(5, counts, cfg, 10),
        0.3, 0.01)
    with mesh_lib.world(1, "cpu", str(tmp_path)) as dev:
        assert torch.distributed.get_world_size() == 1
        assert os.path.exists(tmp_path / ".world_store")
        step = mesh_lib.make_sharded_train_step(
            model, til.LossConfig(), til.OptimizerConfig("sgd"), cfg,
            mesh_lib.make_task_mesh(1, dev), chain_local=True)
        out = step(state, images, masks,
                   tlr.draw_meta_step(5, counts, cfg, 10), 0.3, 0.01)
    assert not torch.distributed.is_initialized()
    for k, v in ref.params.items():
        assert torch.equal(out.params[k], v), k
    for k, v in ref.batch_stats.items():
        assert torch.equal(out.batch_stats[k], v), k
    assert int(out.opt.step) == int(ref.opt.step)
