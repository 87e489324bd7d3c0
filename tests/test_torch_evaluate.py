"""The port's k-shot evaluation against the JAX package's.

The torch twin of tests/tiny_model.py's TinySeg (tests/torch_tiny_model.py)
carries the same weights as the flax one, the episode's draws come from the
JAX key discipline (evaluate.py:110-122), and augmentation and dropout are
off, so one episode is the same deterministic function on both sides, in
float32 on the CPU. The metrics and the evaluation's log lines are held to
the JAX package's; the evaluator's own behaviour (the state it is given
stays unchanged, adaptation helps) to tests/test_evaluate.py's bars.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mliis_tpu.meta import episodes as jep
from mliis_tpu.meta import evaluate as jev
from mliis_tpu.meta import inner_loop as jil
from mliis_tpu.ops import metrics as jmetrics
from mliis_tpu.utils.checkpoint import flatten_tree
from mliis_tpu_torch.data.synthetic import make_synthetic_store
from mliis_tpu_torch.meta import evaluate as tev
from mliis_tpu_torch.meta import inner_loop as til
from mliis_tpu_torch.ops import metrics as tmetrics
from mliis_tpu_torch.utils.checkpoint import params_from_jax
from tests.tiny_model import TinySeg
from tests.torch_tiny_model import TorchTinySeg

IMG = 16


@pytest.fixture(scope="module")
def tiny():
    jmodel = TinySeg()
    jstate = jil.init_model_state(jmodel, jax.random.PRNGKey(0), IMG,
                                  jil.OptimizerConfig("sgd"))
    flat = flatten_tree(jstate.params, "params/")
    flat.update(flatten_tree(jstate.batch_stats, "batch_stats/"))
    tmodel = TorchTinySeg()
    tmodel.load_state_dict(params_from_jax(flat), strict=True)
    tstate = til.init_model_state(tmodel, til.OptimizerConfig("sgd"))
    store = make_synthetic_store(num_tasks=5, examples_per_task=10,
                                 image_size=IMG, seed=0)
    return jmodel, jstate, tmodel, tstate, store


def _jax_draws(key, count, cfg, n_max):
    """The draws of jev.make_adapt_and_predict_fn for `key`."""
    k_sample, k_split, k_batches, _ = jax.random.split(key, 4)
    total = cfg.num_shots + cfg.test_shots
    shot = jep.sample_shot_indices(k_sample, count, total, n_max)
    support, query = jep.split_support_query(k_split, total, cfg.test_shots)
    idx = jep.batch_indices(k_batches, cfg.num_shots, cfg.inner_batch_size,
                            cfg.inner_iters, cfg.replacement)
    return tev.EpisodeDraws(*(torch.tensor(np.asarray(a)).long()
                              for a in (shot, support, query, idx)))


@pytest.mark.parametrize("batch_stats,transductive", [
    (False, True), (True, True), (True, False)],
    ids=["population_stats", "batch_stats_transductive",
         "batch_stats_per_query"])
def test_episode_matches_jax(tiny, batch_stats, transductive):
    """One episode (5 + 5 shots, 4 SGD steps at batch 4, lr 0.05, bce_dice +
    l2, augment and dropout off) with JAX's draws injected, predicting on
    each branch of `use_batch_stats_at_predict`: the query probabilities
    within 1e-5 abs (float32 conv and reduction order over four dependent
    steps) and the per-image IoUs equal."""
    jmodel, jstate, tmodel, tstate, store = tiny
    kw = dict(num_shots=5, test_shots=5, inner_batch_size=4, inner_iters=4,
              augment=False, transductive=transductive,
              use_batch_stats_at_predict=batch_stats)
    jcfg, tcfg = jev.EvalConfig(**kw), tev.EvalConfig(**kw)
    key = jax.random.PRNGKey(17)
    task = 2
    jcore = jax.jit(jev.make_adapt_and_predict_fn(
        jmodel, jil.LossConfig(), jil.OptimizerConfig("sgd"), jcfg, n_max=10))
    _, _, jmasks, jprobs = jcore(
        jstate, *(jnp.asarray(a[task]) for a in (store.images, store.masks,
                                                 store.counts)),
        key, jnp.float32(0.05), jnp.float32(0.0), jnp.float32(0.5))
    jious = np.asarray(jmetrics.batched_hard_iou(
        (jprobs > 0.5).astype(jnp.float32), jmasks))

    draws = _jax_draws(key, jnp.asarray(store.counts[task]), jcfg, 10)
    core = tev.make_adapt_and_predict_fn(tmodel, til.LossConfig(),
                                         til.OptimizerConfig("sgd"), tcfg)
    _, _, tmasks, tprobs = core(
        tstate, torch.from_numpy(store.images[task]),
        torch.from_numpy(store.masks[task]), draws,
        torch.Generator().manual_seed(0), 0.05, drop_rate=0.0)
    np.testing.assert_array_equal(tmasks.numpy(), np.asarray(jmasks))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), atol=1e-5,
                               rtol=0)
    tious = tmetrics.batched_hard_iou((tprobs > 0.5).float(), tmasks)
    np.testing.assert_allclose(tious.numpy(), jious, rtol=1e-6)


def test_metrics_match_jax(rng):
    """batched_hard_iou (rounded scores and labels, with and without a
    class channel) against JAX's batched and per-image hard IoU, ci95 and
    nanmean: 1e-6 rel."""
    pred = rng.random((6, 9, 7, 2)).astype(np.float32)
    label = (rng.random((6, 9, 7, 2)) > 0.5).astype(np.float32)
    pred[0] = 0.0
    label[0] = 0.0                       # empty union: (0 + eps) / (0 + eps)
    for channel in (1, None):
        np.testing.assert_allclose(
            tmetrics.batched_hard_iou(torch.from_numpy(pred),
                                      torch.from_numpy(label),
                                      class_channel=channel).numpy(),
            np.asarray(jmetrics.batched_hard_iou(jnp.asarray(pred),
                                                 jnp.asarray(label),
                                                 class_channel=channel)),
            rtol=1e-6)
        np.testing.assert_allclose(
            float(tmetrics.batched_hard_iou(torch.from_numpy(pred[1:2]),
                                            torch.from_numpy(label[1:2]),
                                            class_channel=channel)[0]),
            float(jmetrics.hard_iou(jnp.asarray(pred[1]),
                                    jnp.asarray(label[1]),
                                    class_channel=channel)), rtol=1e-6)
    values = [0.3, 0.52, np.nan, 0.7, 0.41]
    assert tmetrics.nanmean(values) == jmetrics.nanmean(values)
    assert tmetrics.ci95(values[:2] + values[3:]) == jmetrics.ci95(
        values[:2] + values[3:])


class _FixedEvaluator:
    """Both packages' evaluate_gecko drive `evaluate`; this one returns the
    same per-task IoUs for each sample whatever the key or generator."""

    def __init__(self):
        self.samples = iter([{"a": 0.25, "b": 0.5, "c": float("nan")},
                             {"a": 0.75, "b": 0.125, "c": 0.375}])

    def evaluate(self, *args, **kwargs):
        m = next(self.samples)
        return float(np.nanmean(list(m.values()))), m


def test_evaluate_gecko_lines_match_jax():
    """The two log lines, word for word and number for number, and the
    returned mean and per-task lists, over two samples with a NaN task."""
    jlogs, tlogs = [], []
    jout = jev.evaluate_gecko(_FixedEvaluator(), None, jax.random.PRNGKey(0),
                              0.01, num_samples=2, log_fn=jlogs.append)
    tout = tev.evaluate_gecko(_FixedEvaluator(), None, None, 0.01,
                              num_samples=2, log_fn=tlogs.append)
    assert tlogs == jlogs and len(tlogs) == 2
    assert "95% CI" in tlogs[0]
    assert tout[0] == jout[0]
    assert tout[1].keys() == jout[1].keys()
    for k in jout[1]:
        np.testing.assert_array_equal(tout[1][k], jout[1][k])


def test_state_is_never_mutated(tiny):
    """Evaluating every task (with augmentation, the fused route's plain
    version) leaves the caller's state bit-identical."""
    _, _, tmodel, tstate, store = tiny
    before = {k: v.clone() for k, v in tstate.params.items()}
    before.update({k: v.clone() for k, v in tstate.batch_stats.items()})
    cfg = tev.EvalConfig(num_shots=5, test_shots=5, inner_batch_size=4,
                         inner_iters=2)
    ev = tev.GeckoEvaluator(tmodel, til.LossConfig(l2=False),
                            til.OptimizerConfig("sgd"), cfg, store,
                            device="cpu")
    miou, task_map = ev.evaluate(tstate, torch.Generator().manual_seed(1),
                                 lr=0.05, eval_all_tasks=True)
    assert set(task_map) == set(store.names) and 0.0 <= miou <= 1.0
    for k, v in list(tstate.params.items()) + list(
            tstate.batch_stats.items()):
        assert torch.equal(v, before[k]), k
    _, sub = ev.evaluate(tstate, torch.Generator().manual_seed(1), lr=0.05,
                         num_tasks_to_sample=2)
    assert len(sub) == 2


def test_adaptation_improves_over_no_adaptation(tiny):
    """40 adaptation steps at a sane lr beat one step at a near-zero lr on
    learnable synthetic tasks by more than 0.05 mean IoU (augment off)."""
    _, _, tmodel, tstate, store = tiny
    base = dict(num_shots=5, test_shots=5, inner_batch_size=4, augment=False)
    mious = []
    for iters, lr in ((1, 1e-6), (40, 0.05)):
        ev = tev.GeckoEvaluator(tmodel, til.LossConfig(l2=False),
                                til.OptimizerConfig("sgd"),
                                tev.EvalConfig(inner_iters=iters, **base),
                                store, device="cpu")
        mious.append(ev.evaluate(tstate, torch.Generator().manual_seed(2),
                                 lr=lr, eval_all_tasks=True,
                                 aug_rate=None)[0])
    assert mious[1] > mious[0] + 0.05
